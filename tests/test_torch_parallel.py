"""fasterseg_tpu_torch.parallel on the CPU: two gloo ranks against one process
on the concatenated batch, and against the JAX package's `make_mesh(2)`.

One spawn of two ranks (`launch`, a FileStore under tmp_path, two torch
threads a rank) runs every case of `_torch_parallel_workers`; the test
process runs the same functions without a mesh on the whole batch. Bars, in
float64: sync BN (plain and slim rows) forward, input and parameter
gradients and running statistics atol 1e-12; the losses' shares summed over
ranks rtol 1e-12 and their gradients atol 1e-12, OHEM's threshold equal; the
dry run's distill step and search steps (every parameter, BN statistic,
momentum and arch tensor and the losses) atol 1e-10 + rtol 1e-8 against the
one-rank step and equal across ranks, `loss_latency` rtol 1e-12; the
evaluator's hist and scores identical; the loader's shards equal the
one-rank batch bit for bit. Against the JAX package (fp32): its
`make_train_step` jitted over `make_mesh(2)` as `__graft_entry__.py` does,
within tests/test_torch_train_step.py's bars, and its `Evaluator(mesh=
make_mesh(2))` within tests/test_torch_eval.py's.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from fasterseg_tpu.eval.evaluator import Evaluator as JaxEvaluator
from fasterseg_tpu.parallel import DATA_AXIS
from fasterseg_tpu.parallel import make_mesh as jax_make_mesh
from fasterseg_tpu.train.loop import (create_train_state,
                                      make_optimizer as jax_make_optimizer,
                                      make_train_step)
import _torch_parallel_workers as W
from fasterseg_tpu_torch.parallel import launch, rank_devices
from test_torch_eval import NEAR_TIE, _jax_multiscale_probs
from test_torch_train_step import OPT, _jax_state_dict, _nets, _teacher_plans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "tests", "assets")
RANKS = 2
BN_ATOL = LOSS_ATOL = 1e-12
LOSS_RTOL = 1e-12
TRAIN_HW = (64, 128)
TRAIN_BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module's one-process references run
    (the ranks hold themselves to two)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_train():
    """The JAX package's student (the 19-class synthetic plan of
    test_torch_train_step.py, seed 0) and frozen teacher (seed 1), the port's
    nets loaded with their weights, and a batch of 4 at 64x128 whose images
    ignore different shares of their labels."""
    jplan, tplan = _teacher_plans()
    model, variables, net = _nets(jplan, tplan, 0)
    tmodel, tvars, tnet = _nets(jplan, tplan, 1)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((TRAIN_BATCH, *TRAIN_HW, 3)).astype(np.float32)
    y = rng.integers(0, 19, (TRAIN_BATCH, *TRAIN_HW)).astype(np.int32)
    for i in range(TRAIN_BATCH):
        y[i][rng.random(TRAIN_HW) < 0.05 + 0.2 * i] = 255
    step = dict(min_kept=TRAIN_BATCH * TRAIN_HW[0] * TRAIN_HW[1] // 16,
                thresh=0.7, aux_weight=0.2, num_classes=19)
    payload = {"plan": tplan, "student": net.state_dict(),
               "teacher": tnet.state_dict(), "opt": OPT, "step": step,
               "x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    return {"jplan": jplan, "tplan": tplan, "model": model,
            "variables": variables, "net": net, "tmodel": tmodel,
            "tvars": tvars, "payload": payload}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_train):
    """Every case on two gloo ranks on the CPU, in rank order."""
    return launch(W.rank_job, RANKS, "gloo", ["cpu"] * RANKS,
                  args=(jax_train["payload"],),
                  store_dir=str(tmp_path_factory.mktemp("store")))


def _cat(ranks, *path):
    """The ranks' tensors at `path`, concatenated along the batch."""
    parts = []
    for r in ranks:
        v = r
        for p in path:
            v = v[p]
        parts.append(v)
    return torch.cat(parts)


# ---- two ranks against one process ----


@pytest.mark.parametrize("kind", ["plain", "slim"])
def test_sync_bn_matches_one_process(ranks, kind):
    want = W.bn_case(None)[kind]
    for key in ("y", "x_grad"):
        torch.testing.assert_close(_cat(ranks, "bn", kind, key), want[key],
                                   atol=BN_ATOL, rtol=0)
    for key in ("weight_grad", "bias_grad", "running_mean", "running_var"):
        for r in ranks:
            torch.testing.assert_close(r["bn"][kind][key], want[key],
                                       atol=BN_ATOL, rtol=0)
        assert torch.equal(ranks[0]["bn"][kind][key],
                           ranks[1]["bn"][kind][key])


def test_ohem_threshold_is_global(ranks):
    """min_kept 100 over 96 pixels a rank: each rank's threshold is the
    global batch's, not the one its own shard would give."""
    from fasterseg_tpu_torch.train.loss import ohem_threshold
    want = W.loss_case(None)["threshold"]
    assert 0.02 < want < 1.0
    logits, labels, _, _ = W.loss_inputs()
    valid = labels != 255
    p_true = torch.gather(torch.softmax(logits, -1), -1,
                          torch.where(valid, labels, 0)[..., None])[..., 0]
    p_true = torch.where(valid, p_true, 1.0)
    for i, r in enumerate(ranks):
        assert torch.equal(r["losses"]["threshold"], want)
        own = ohem_threshold(p_true[2 * i:2 * i + 2], 0.02, 100)
        assert not torch.equal(own, want)


@pytest.mark.parametrize("name", ["ohem", "ohem_weighted", "topk",
                                  "topk_thresh", "ce", "focal", "kl",
                                  "soft"])
def test_loss_shares_sum_to_the_global_loss(ranks, name):
    want = W.loss_case(None)[name]
    got = sum(r["losses"][name]["value"] for r in ranks)
    torch.testing.assert_close(got, want["value"], rtol=LOSS_RTOL, atol=0)
    torch.testing.assert_close(_cat(ranks, "losses", name, "grad"),
                               want["grad"], atol=LOSS_ATOL, rtol=0)


def test_shards_have_different_counts():
    """The losses' cases mean something: the two shards keep different
    numbers of valid pixels."""
    _, labels, _, _ = W.loss_inputs()
    valid = (labels != 255).reshape(RANKS, -1).sum(1)
    assert valid[0] != valid[1]


@pytest.mark.parametrize("step", ["distill", "search"])
def test_dryrun_steps_match_one_rank(ranks, step):
    for r in ranks:
        res = r["steps"][step]
        assert res["over"] == [] and res["same_on_ranks"], res
        assert res["max_abs_err"] < 1e-10
        assert np.isfinite(res["loss"]) and res["bytes_all_reduced"] > 0
    assert ranks[0]["steps"][step]["loss"] == ranks[1]["steps"][step]["loss"]


@pytest.mark.parametrize("name", ["single", "single_batch2", "multi_flip"])
def test_evaluator_matches_one_process(ranks, name):
    """Batch 2 over 5 scenes: the ranks' last global batch (4, pad) is
    padded as the one process's is."""
    want = W.eval_case(None)[name]
    for r in ranks:
        got = r["eval"][name]
        np.testing.assert_array_equal(got["hist"], want["hist"])
        assert got["pixel_acc"] == want["pixel_acc"]
        assert got["mean_iu"] == want["mean_iu"] or (
            np.isnan(got["mean_iu"]) and np.isnan(want["mean_iu"]))
    assert want["hist"].sum() > 0


def test_loader_shards_concatenate_to_the_batch(ranks):
    want = W.loader_case(None)
    for step in range(2):
        for part in range(2):
            got = np.concatenate([r["loader"][step][part] for r in ranks])
            assert got.dtype == want[step][part].dtype
            np.testing.assert_array_equal(got, want[step][part])
    assert ranks[0]["loader"][0][0].shape[0] == 2


# ---- against the JAX package's make_mesh(2) ----


def test_train_step_matches_jax_mesh(ranks, jax_train):
    """`make_train_step` jitted over `make_mesh(2)` (params replicated, the
    batch sharded) against the port's two ranks, from the same weights:
    loss and loss_kl rtol 1e-5, inter and union up to the near-tie pixels,
    every tensor within 10 % of the JAX update's largest step + 1e-6."""
    j = jax_train
    pay = j["payload"]
    mesh = jax_make_mesh(RANKS)
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P(DATA_AXIS))
    tx = jax_make_optimizer(**OPT)
    jstate = jax.device_put(create_train_state(j["variables"], tx), repl)
    tvars = jax.device_put({"params": j["tvars"]["params"],
                            "batch_stats": j["tvars"]["batch_stats"]}, repl)
    jstep = jax.jit(make_train_step(j["model"], tx, teacher_model=j["tmodel"],
                                    **pay["step"]),
                    in_shardings=(repl, data, data, repl),
                    out_shardings=(repl, repl))
    x, y = pay["x"].numpy(), pay["y"].numpy()
    jstate, jm = jstep(jstate, jax.device_put(jnp.asarray(x), data),
                       jax.device_put(jnp.asarray(y), data), tvars)
    jm = jax.tree_util.tree_map(np.asarray, jm)
    for r in ranks:
        tm = r["jax_train"]["metrics"]
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["loss_kl"]) == pytest.approx(float(jm["loss_kl"]),
                                                      rel=1e-5)
        assert float(tm["loss_kl"]) > 0
    # near-ties of p8 (the train-mode forward of the global batch)
    with torch.no_grad():
        p8 = copy.deepcopy(j["net"]).train()(pay["x"])[0].numpy()
    top2 = np.sort(p8, -1)[..., -2:]
    ties = int((top2[..., 1] - top2[..., 0] < 2e-3).sum())
    tm = ranks[0]["jax_train"]["metrics"]
    assert np.abs(tm["inter"].numpy() - jm["inter"]).sum() <= 2 * ties
    assert np.abs(tm["union"].numpy() - jm["union"]).sum() <= 2 * ties
    before = j["net"].state_dict()
    want = _jax_state_dict(j["tplan"], jstate.params, jstate.batch_stats)
    for r in ranks:
        got = r["jax_train"]["state"]
        for k, w in want.items():
            step = (w - before[k]).abs().max().item()
            err = (got[k] - w).abs().max().item()
            assert err <= 0.1 * step + 1e-6, (k, err, step)
    for k, v in ranks[0]["jax_train"]["state"].items():
        assert torch.equal(v, ranks[1]["jax_train"]["state"][k]), k


def _jax_shared_forward():
    fwd = W.SharedForward()

    def jax_fwd(variables, x):
        m = jnp.asarray(fwd.m)
        out = x[..., 0:1] * m[0] + x[..., 1:2] * m[1] + x[..., 2:3] * m[2]
        return out + jnp.asarray(fwd.bias(x.shape[1], x.shape[2]))
    return jax_fwd


def test_evaluator_matches_jax_mesh(ranks):
    """The JAX Evaluator over `make_mesh(2)` (batches sharded, the padded
    tail masked) and the port's two ranks on the shared forward: single
    scale + flip counts equal; multi-scale + flip counts apart by at most
    two for each near-tie pixel of the JAX probability sum."""
    mesh = jax_make_mesh(RANKS)
    ds = W.shared_dataset()
    kw = dict(num_classes=W.SHARED_CLASSES, image_mean=W.MEAN,
              image_std=W.STD, forward_fn=_jax_shared_forward(),
              eval_flip=True, mesh=mesh)
    want = JaxEvaluator(ds, **kw).run({})
    for r in ranks:
        got = r["shared_eval"]["single_flip"]
        np.testing.assert_array_equal(got["hist"], want.hist)
        assert got["pixel_acc"] == want.pixel_acc
        assert got["mean_iu"] == want.mean_iu
    jev = JaxEvaluator(ds, eval_scales=(0.5, 1.0, 1.5), **kw)
    want = jev.run({})
    imgs = np.stack([ds[i]["data"] for i in range(len(ds))])
    jev_one = JaxEvaluator(ds, eval_scales=(0.5, 1.0, 1.5),
                           **{**kw, "mesh": None})
    probs = _jax_multiscale_probs(jev_one, imgs)
    top2 = np.sort(probs, -1)[..., -2:]
    ties = int((top2[..., 1] - top2[..., 0] < NEAR_TIE).sum())
    for r in ranks:
        got = r["shared_eval"]["multi_flip"]
        assert got["hist"].sum() == want.hist.sum()
        assert np.abs(got["hist"] - want.hist).sum() <= 2 * ties


# ---- options and entry points ----


def test_cli_eval_spatial_prints_the_one_rank_table(tmp_path, capfd):
    """cli/eval.py --devices 2 --spatial --device cpu: two gloo ranks split
    each image of a ProcCity file list over H; rank 0 prints the table
    that the one-process run prints."""
    pytest.importorskip("cv2")
    from fasterseg_tpu_torch.cli import eval as cli_eval
    from fasterseg_tpu_torch.core.config import cityscapes_student_config
    from fasterseg_tpu_torch.data.procgen import write_dataset
    from fasterseg_tpu_torch.train import TrainSession
    import dataclasses
    cfg = dataclasses.replace(cityscapes_student_config(), is_eval=True)
    TrainSession(cfg, ASSETS, device="cpu").save(str(tmp_path / "run"))
    root = write_dataset(str(tmp_path / "data"), n_train=1, n_val=2,
                         hw=(128, 256))
    os.replace(os.path.join(root, "val.txt"),
               os.path.join(root, "cityscapes_val_fine.txt"))
    argv = ["--arch-dir", ASSETS, "--device", "cpu", "--ckpt",
            str(tmp_path / "run" / "weights1_ckpt"), "--data-root", root]
    one = cli_eval.main(argv)
    table = capfd.readouterr().out
    split = cli_eval.main(argv + ["--devices", "2", "--spatial"])
    printed = capfd.readouterr().out
    assert "mean_IU" in table
    np.testing.assert_array_equal(split.hist, one.hist)
    assert table.strip().splitlines()[-8:] == printed.strip().splitlines()[-8:]
    with pytest.raises(SystemExit):
        cli_eval.main(argv + ["--spatial"])


def test_devices_beyond_the_cards_raise(monkeypatch, tmp_path):
    """More NCCL ranks than cards raise before anything starts, and so
    does a named card (no rank is folded onto a card); the CPU takes
    gloo."""
    from fasterseg_tpu_torch.cli import eval as cli_eval
    from fasterseg_tpu_torch.cli import train, train_search
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rank_devices(1, "cuda") == ("nccl", ["cuda:0"])
    assert rank_devices(3, "cpu") == ("gloo", ["cpu"] * 3)
    with pytest.raises(ValueError, match="2 ranks need 2 cards"):
        rank_devices(2, "cuda")
    for named in ("cuda:0", "cuda:1"):
        with pytest.raises(ValueError, match=f"not {named}"):
            rank_devices(1, named)
    save = str(tmp_path / "runs")
    for argv, cli in (
            (["--arch-dir", "tests/assets", "--synthetic", "--save", save],
             train),
            (["--synthetic", "--save", save], train_search),
            (["--arch-dir", "tests/assets", "--ckpt", "unused",
              "--data-root", str(tmp_path)], cli_eval)):
        with pytest.raises(ValueError, match="2 ranks need 2 cards"):
            cli.main(argv + ["--devices", "2"])
    assert not os.path.exists(save)


class _StubMesh:
    """A rank's view of a world of `world` ranks without a process group:
    enough to build a session (its broadcasts leave the weights as
    drawn)."""

    def __init__(self, world: int):
        self.rank, self.world = 0, world
        self.device = torch.device("cpu")

    def broadcast_(self, tensors, src=0):
        pass


def test_eval_session_takes_any_world():
    """An eval session shards images, not the training batch, so any world
    builds one; a training session needs the batch to divide."""
    import dataclasses
    from fasterseg_tpu_torch.core.config import cityscapes_student_config
    from fasterseg_tpu_torch.train import TrainSession
    cfg = cityscapes_student_config()
    world = cfg.data.batch_size + 1
    with pytest.raises(ValueError, match=f"over {world} ranks"):
        TrainSession(cfg, "tests/assets", device="cpu",
                     mesh=_StubMesh(world))
    session = TrainSession(dataclasses.replace(cfg, is_eval=True),
                           "tests/assets", device="cpu",
                           mesh=_StubMesh(world))
    assert session.mesh.world == world


def test_dryrun_cli_exits_zero():
    """`python -m fasterseg_tpu_torch.parallel.dryrun 2 --device cpu`: both
    steps held against one rank (float64), one line each."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m",
                          "fasterseg_tpu_torch.parallel.dryrun", "2",
                          "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("dryrun")]
    assert len(lines) == 2 and all(ln.endswith("OK") for ln in lines), \
        out.stdout
