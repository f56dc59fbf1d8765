"""The port's self-search chain (fasterseg_tpu_torch/cli/self_search.py)
against the JAX package's scripts/self_search.py, on the CPU. The JAX
script's pure functions are imported from it; none of its `cmd_*` runs
(they write under artifacts/self_search and over SEARCH.md).

* `search_config` and `train_config` equal the JAX script's field by field,
  the band passed in and the pretrain checkpoint's path apart.
* `data.InMemoryDataset` over rendered scenes gives the file-list route's
  batches over the same scenes written by `write_dataset`: the search's
  shared permutation, both `portion` halves, one rank and two.
* `chain` at a tiny configuration (5 layers, Fch 8, 64x128, 16 + 4 scenes,
  one step an epoch) runs every stage with `--device cpu` and writes the
  band, both archs, the four train logs, fps.json and the report.
* The report fed the JAX chain's round-4 search (evidence/self_search_r4:
  metrics.jsonl and arch_1.npz, no band.json) reproduces SEARCH.md's
  trajectory rows, its in-band epochs line and its decoded-cells line
  verbatim.
* The round-4 arch_1.npz decodes to the plan of the JAX script's decode
  chain (`_searched_student_plan`'s steps).
"""

import dataclasses
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest

from fasterseg_tpu_torch.cli import self_search as ss

from _torch_search_common import few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(REPO, "evidence", "self_search_r4")
TINY = ["--layers", "5", "--Fch", "8", "--scenes", "16,4", "--hw", "64,128",
        "--search-crop", "64,128", "--fps-hw", "64,128", "--niters", "1",
        "--max-eval-items", "2"]


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_self_search", os.path.join(REPO, "scripts", "self_search.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("pretrain", [True, False])
def test_search_config_is_the_jax_scripts(jax_script, pretrain):
    want = dataclasses.asdict(jax_script.search_config(pretrain))
    band = (want["fps_min"][1], want["fps_max"][1])
    got = dataclasses.asdict(ss.search_config(pretrain, band))
    assert got.pop("load_path") == (None if pretrain else os.path.join(
        ss.OUT, "pretrain"))
    want.pop("load_path")
    assert got == want
    assert got["compute_dtype"] == "bfloat16"


@pytest.mark.parametrize("mode", ["teacher", "student"])
def test_train_config_is_the_jax_scripts(jax_script, mode):
    assert (dataclasses.asdict(ss.train_config(mode))
            == dataclasses.asdict(jax_script.train_config(mode)))


def test_band_is_fps_band_of_the_shipped_8_class_student():
    from fasterseg_tpu_torch.latency import H100CostModel, fps_band, h100_lut
    table = h100_lut(H100CostModel().provider)
    lo, hi = fps_band(table, ss.shipped_student_plan())
    assert ss.band(table) == (round(lo, 1), round(hi, 1))
    assert ss.shipped_student_plan().num_classes == 8


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """16 + 4 ProcCity scenes at 64x128, written as PNGs and file lists
    (cv2) and rendered into memory."""
    from fasterseg_tpu_torch.data.procgen import write_dataset
    root = str(tmp_path_factory.mktemp("proccity"))
    write_dataset(root, n_train=16, n_val=4, hw=(64, 128), seed=0)
    setup = ss.Setup(hw=(64, 128), scenes=(16, 4))
    return root, ss.scenes(setup)


@pytest.mark.parametrize("portion", [0.5, -0.5])
@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_in_memory_loader_gives_the_file_list_batches(written, portion,
                                                      shard):
    from fasterseg_tpu_torch.data import InMemoryDataset, get_train_loader
    from fasterseg_tpu_torch.data.procgen import make_dataset_cls
    root, (train, _) = written
    setup = ss.Setup(hw=(64, 128), search_crop=(48, 96), scenes=(16, 4))
    cfg = ss.search_config(False, (1.0, 2.0), setup)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, dataset_path=root))
    perm = list(np.random.default_rng(cfg.seed).permutation(
        cfg.data.num_train_imgs))
    loaders = [get_train_loader(cfg, cls, portion=portion,
                                index_select=perm, shard=shard)
               for cls in (make_dataset_cls(), InMemoryDataset.bind(train))]
    try:
        assert len(loaders[0].dataset) == len(loaders[1].dataset) == 8
        for epoch, step in ((0, 0), (0, 3), (2, 1)):
            (xa, ya), (xb, yb) = (ld.make_batch(epoch, step)
                                  for ld in loaders)
            assert xa.shape == (2 // shard[1], 48, 96, 3)
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    finally:
        for ld in loaders:
            ld.close()


def test_in_memory_dataset_oversamples_as_the_file_list():
    from fasterseg_tpu_torch.data import InMemoryDataset
    ds = InMemoryDataset.bind([{"n": i} for i in range(5)])(
        None, "train", portion=-0.4, index_select=[4, 3, 2, 1, 0],
        file_length=7)
    assert len(ds) == 7
    assert [ds[i]["n"] for i in range(7)] == [1, 0, 1, 0, 1, 0, 1]


def test_tiny_chain_runs_every_stage(tmp_path, capsys):
    out = str(tmp_path / "run")
    ss.main(["chain", "--device", "cpu", "--out", out, "--pretrain-epochs",
             "1", "--search-epochs", "1", "--train-epochs", "1", *TINY])
    for name in ("pretrain/arch_0.npz", "pretrain/weights_ckpt",
                 "search/arch_1.npz", "search/band.json",
                 "train_teacher.jsonl", "train_student.jsonl",
                 "train_teacher_shipped.jsonl", "train_student_shipped.jsonl",
                 "teacher_ckpt", "teacher_ckpt_shipped", "fps.json",
                 "SEARCH.md", "searched_ops1.png", "searched_path_width.png"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "fps.json")) as f:
        fps = json.load(f)
    assert fps["serving_path"] == "plain" and fps["device"] == "cpu"
    assert fps["measured_ms"] > 0 and fps["lut_est_ms"] > 0
    with open(os.path.join(out, "search", "band.json")) as f:
        band = json.load(f)["fps_band"]
    with open(os.path.join(out, "SEARCH.md")) as f:
        text = f.read()
    for section in ("## Search trajectory (student)",
                    f"inside the {tuple(band)} band",
                    "## Searched student genotype",
                    "![ops](searched_ops1.png)", "Decoded cells per branch",
                    "## Outcome vs shipped genotype",
                    "| student FPS @64x128 (LUT est / measured, plain, "
                    "cpu) |"):
        assert section in text, section
    # a second chain resumes every stage and trains no more epochs
    with open(os.path.join(out, "train_student.jsonl")) as f:
        before = f.read()
    ss.main(["chain", "--device", "cpu", "--out", out, "--pretrain-epochs",
             "1", "--search-epochs", "1", "--train-epochs", "1", *TINY])
    with open(os.path.join(out, "train_student.jsonl")) as f:
        assert f.read() == before


def test_report_raises_on_a_missing_arm(tmp_path):
    os.makedirs(tmp_path / "search")
    for name in ("metrics.jsonl", "arch_1.npz"):
        shutil.copy(os.path.join(R4, "search", name), tmp_path / "search")
    with pytest.raises(FileNotFoundError, match="train_teacher.jsonl"):
        ss.report(ss.Setup(out=str(tmp_path)))


def test_report_of_the_round4_search_reproduces_search_md(tmp_path):
    """SEARCH.md was written by the JAX report from these files with the
    hand-picked band (no band.json): its trajectory rows, in-band epochs
    and decoded cells come out verbatim."""
    os.makedirs(tmp_path / "search")
    for name in ("metrics.jsonl", "arch_1.npz"):
        shutil.copy(os.path.join(R4, "search", name), tmp_path / "search")
    for stage in ("teacher", "student"):
        for suffix in ("", "_shipped"):
            shutil.copy(os.path.join(R4, f"train_{stage}.jsonl"),
                        tmp_path / f"train_{stage}{suffix}.jsonl")
    text = ss.report(ss.Setup(out=str(tmp_path)))
    with open(os.path.join(REPO, "SEARCH.md")) as f:
        want = f.read().splitlines()
    start = want.index("## Search trajectory (student)")
    rows = want[start:want.index("## Searched student genotype")]
    assert len([r for r in rows if r.startswith("| ")]) == 1 + 31
    got = text.splitlines()
    i = got.index(rows[0])
    assert got[i:i + len(rows)] == rows
    decoded = [l for l in want if l.startswith("Decoded cells per branch")]
    assert len(decoded) == 1 and decoded[0] in got
    assert "![ops](searched_ops1.png)" in got
    assert os.path.getsize(tmp_path / "searched_path_width.png") > 1000
    with open(tmp_path / "SEARCH.md") as f:
        assert f.read() == text


def test_round4_student_decodes_as_the_jax_chain():
    from fasterseg_tpu.core import ArchParams
    from fasterseg_tpu.core.config import WIDTH_MULT_LIST
    from fasterseg_tpu.core.genotype import decode_network
    from fasterseg_tpu.core.plan import build_plan, select_lasts
    path = os.path.join(R4, "search", "arch_1.npz")
    d = np.load(path)
    genos = decode_network(ArchParams.from_npz(path), WIDTH_MULT_LIST,
                           layers=16, ignore_skip=False)
    lasts = select_lasts(float(d["mIoU02"]), float(d["latency02"]),
                         float(d["mIoU12"]), float(d["latency12"]))
    want = build_plan(genos, list(lasts), Fch=12, num_classes=8,
                      stem_head_width=(8.0 / 12, 8.0 / 12))
    plan, got_lasts = ss.searched_student_plan(path)
    assert got_lasts == list(lasts) == [2, 0]
    assert dataclasses.asdict(plan) == dataclasses.asdict(want)
