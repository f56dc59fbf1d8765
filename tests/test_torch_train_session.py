"""fasterseg_tpu_torch's training driver on the CPU at a tiny size: teacher
then student from the teacher's checkpoint, exact resume, partial-match
loading against the JAX package's, evaluation and test predictions through
the fp32 runner, and the train / eval CLIs end to end.
"""

import dataclasses
import glob
import logging
import os

import numpy as np
import pytest
import torch

from fasterseg_tpu.utils.checkpoint import partial_load as jax_partial_load
from fasterseg_tpu_torch.core.config import (DataConfig,
                                             cityscapes_student_config,
                                             cityscapes_teacher_config)
from fasterseg_tpu_torch.data import SyntheticDataset
from fasterseg_tpu_torch.data.procgen import ProcCity
from fasterseg_tpu_torch.eval import Evaluator
from fasterseg_tpu_torch.train import (TrainSession, make_eval_step,
                                       run_train, write_test_predictions)
from fasterseg_tpu_torch.utils.checkpoint import load, partial_load

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
DATA = DataConfig(synthetic=True, synthetic_length=4, image_height=32,
                  image_width=64, batch_size=2)


def _cfg(student: bool):
    """Teacher at 32x64; the student's zoomed cells at 1/32 need 64x128."""
    base = cityscapes_student_config() if student else \
        cityscapes_teacher_config()
    data = dataclasses.replace(DATA, image_height=64, image_width=128) \
        if student else DATA
    return dataclasses.replace(base, data=data, niters_per_epoch=2)


@pytest.fixture(scope="module")
def teacher_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("teacher")
    session = run_train(_cfg(False), ASSETS, epochs=2, niters=2,
                        save_dir=str(d), device="cpu")
    return session, d


def test_teacher_then_student(teacher_run, tmp_path):
    """run_train in teacher mode writes weights0_ckpt; run_train in student
    mode loads it into the frozen teacher (no key missing) and trains the
    student with the KL term."""
    teacher, tdir = teacher_run
    assert teacher.state.step == 4 and not teacher.is_student
    ckpt = os.path.join(tdir, "weights0_ckpt")
    assert os.path.exists(ckpt) and os.path.exists(tdir / "resume_ckpt")
    saved = load(ckpt)
    for k, v in teacher.model.state_dict().items():
        assert torch.equal(saved[k], v), k
    res = TrainSession(_cfg(True), ASSETS, device="cpu") \
        .load_teacher_weights(ckpt)
    assert res.missing == res.unexpected == res.mismatched == []

    init = TrainSession(_cfg(True), ASSETS, device="cpu").model.state_dict()
    session = run_train(_cfg(True), ASSETS, epochs=2, niters=2,
                        save_dir=str(tmp_path), teacher_ckpt=ckpt,
                        device="cpu")
    assert session.is_student and session.state.step == 4
    for k, v in session.teacher.state_dict().items():
        assert torch.equal(v, saved[k]), k   # loaded, and stays frozen
    after = session.model.state_dict()
    assert not torch.equal(after["stem.0.conv.0.weight"],
                           init["stem.0.conv.0.weight"])
    assert not torch.equal(after["stem.0.conv.1.running_var"],
                           init["stem.0.conv.1.running_var"])
    group = session.state.optimizer.param_groups[0]
    assert group["lr"] == pytest.approx(0.01 * 0.992, rel=1e-12)
    from fasterseg_tpu_torch.data import get_train_loader
    loader = get_train_loader(session.config, None)
    try:
        stats = session.train_epoch(loader, 2, 2)
    finally:
        loader.close()
    assert all(np.isfinite(stats["losses"])) and len(stats["losses"]) == 2
    assert all(k > 0 for k in stats["losses_kl"])
    assert 0.0 <= stats["train_mIoU"] <= 1.0


def test_resume_is_bit_exact(tmp_path):
    """4 epochs unbroken against 2, a new process-like session restored from
    the checkpoint, and 2 more: weights, BN statistics, momentum buffers and
    the update count equal bit for bit."""
    cfg = _cfg(False)
    unbroken = run_train(cfg, ASSETS, epochs=4, niters=2,
                         save_dir=str(tmp_path / "a"), device="cpu")
    run_train(cfg, ASSETS, epochs=2, niters=2, save_dir=str(tmp_path / "b"),
              device="cpu")
    resumed = run_train(cfg, ASSETS, epochs=4, niters=2,
                        save_dir=str(tmp_path / "b"), resume=True,
                        device="cpu")
    assert unbroken.state.step == resumed.state.step == 8
    a, b = unbroken.model.state_dict(), resumed.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    oa = unbroken.state.optimizer.state_dict()
    ob = resumed.state.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        assert torch.equal(oa["state"][i]["momentum_buffer"],
                           ob["state"][i]["momentum_buffer"])


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def test_partial_load_lists_match_jax(caplog):
    """The same keys in both packages (dotted in the port, a nested tree in
    the JAX package): the merged values and the three warnings (count and
    first examples) agree."""
    rng = np.random.default_rng(0)
    t = lambda *s: rng.standard_normal(s).astype(np.float32)
    target = {"stem.0.weight": t(4, 3), "stem.0.bias": t(4),
              "cells.1.w": t(2, 2), "cells.2.w": t(3), "head.w": t(5),
              "head.b": t(5)}
    loaded = {"stem.0.weight": t(4, 3), "stem.0.bias": t(3),
              "cells.1.w": t(2, 2), "head.w": t(5), "aux.w": t(1),
              "aux.b": t(2)}
    caplog.set_level(logging.WARNING)
    got = partial_load({k: torch.from_numpy(v) for k, v in target.items()},
                       {k: torch.from_numpy(v) for k, v in loaded.items()})
    port_records = [r for r in caplog.records if r.name == "fasterseg_tpu_torch"]
    caplog.clear()
    merged = jax_partial_load(_nest(target), _nest(loaded))
    jax_records = [r for r in caplog.records if r.name == "fasterseg_tpu"]
    dotted = lambda paths: [p.lstrip("/").replace("/", ".") for p in paths]
    lists = (got.missing, got.unexpected, got.mismatched)
    assert lists == (["cells.2.w", "head.b"],
                     ["stem.0.bias", "aux.w", "aux.b"], ["stem.0.bias"])
    assert len(jax_records) == len(port_records) == 3
    for lst, jr, pr in zip(lists, jax_records, port_records):
        assert jr.args[0] == pr.args[0] == len(lst)
        assert dotted(jr.args[1]) == pr.args[1] == lst[:3]
    flat = {}

    def walk(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                flat[prefix + k] = v
    walk(merged)
    assert flat.keys() == got.state.keys()
    for k in flat:
        np.testing.assert_array_equal(np.asarray(flat[k]),
                                      got.state[k].numpy())


def test_evaluate_and_test_predictions(teacher_run, tmp_path):
    """evaluate() through the fp32 runner of the current weights equals an
    Evaluator over the plain eval-mode network; the submission PNGs are the
    eval step's class maps."""
    cv2 = pytest.importorskip("cv2")
    session, _ = teacher_run
    ds = [ProcCity(length=2, hw=(64, 128), seed=1, split="val")[i]
          for i in range(2)]
    res = session.evaluate(ds)
    net = session.model.eval()
    plain = Evaluator(ds, 19, DATA.image_mean, DATA.image_std,
                      lambda x: net(x), device="cpu").run()
    assert res.hist.sum() == plain.hist.sum() > 0
    assert 0.5 * np.abs(res.hist - plain.hist).sum() / res.hist.sum() <= 1e-3
    write_test_predictions(session, ds, str(tmp_path), remap=None)
    eval_step = make_eval_step(net)
    from fasterseg_tpu_torch.data.preprocess import eval_preprocess
    for s in ds:
        png = cv2.imread(str(tmp_path / f"{s['fn']}.png"),
                         cv2.IMREAD_GRAYSCALE)
        x = torch.from_numpy(eval_preprocess(s["data"], DATA.image_mean,
                                             DATA.image_std)[None])
        want = eval_step(x)[0].numpy()
        assert png.shape == want.shape
        assert (png == want).mean() >= 0.999


def test_cli_train_then_eval(tmp_path, capsys):
    """cli.train --synthetic --device cpu (teacher, one epoch) writes a run
    directory; cli.eval evaluates its checkpoint on a ProcCity file-list
    dataset read with cv2."""
    pytest.importorskip("cv2")
    from fasterseg_tpu_torch.cli import eval as cli_eval
    from fasterseg_tpu_torch.cli import train as cli_train
    from fasterseg_tpu_torch.data.procgen import write_dataset
    session = cli_train.main([
        "--mode", "teacher", "--arch-dir", ASSETS, "--synthetic",
        "--device", "cpu", "--save", str(tmp_path / "runs"), "--epochs", "1",
        "--niters", "2", "--batch-size", "2", "--height", "32",
        "--width", "64"])
    assert session.state.step == 2
    (run,) = glob.glob(str(tmp_path / "runs" / "train-teacher-*"))
    assert os.path.exists(os.path.join(run, "weights0_ckpt"))
    assert os.path.exists(os.path.join(run, "log.txt"))
    root = write_dataset(str(tmp_path / "data"), n_train=1, n_val=2,
                         hw=(64, 128))
    os.replace(os.path.join(root, "val.txt"),
               os.path.join(root, "cityscapes_val_fine.txt"))
    res = cli_eval.main([
        "--mode", "teacher", "--arch-dir", ASSETS, "--device", "cpu",
        "--ckpt", os.path.join(run, "weights0_ckpt"), "--data-root", root,
        "--show-dir", str(tmp_path / "show")])
    assert res.hist.sum() > 0
    assert "mean_IU" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "show")) == 2


def test_session_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainSession(_cfg(False), ASSETS)
