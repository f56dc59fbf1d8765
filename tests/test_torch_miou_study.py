"""The port's ProcCity mIoU study (cli/miou_study.py) and int8 check
(cli/int8_check.py) on the CPU.

The study's configuration equals the JAX script's field by field, its JAX
columns equal MIOU.md, and a tiny run (2 epochs x 2 steps at 64x128 on 8
scenes, teacher then student from the teacher's checkpoint) writes rows with
the JAX schema that `report` reads back; the int8 check runs on that
student.
"""

import dataclasses
import importlib.util
import json
import os
import re

import pytest
import torch

from fasterseg_tpu_torch.cli import int8_check, miou_study
from _torch_search_common import few_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_HW = (64, 128)
JAX_ROW_KEYS = {"side", "stage", "epoch", "step", "loss", "train_mIoU",
                "val_mIoU", "wall_s"}


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_miou_study", os.path.join(REPO, "scripts", "miou_study.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["teacher", "student"])
def test_study_config_equals_jax_script(mode):
    jax_cfg = _jax_script().study_config(mode)
    cfg = miou_study.study_config(mode)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    assert (cfg.data.image_height, cfg.data.image_width) == (256, 512)
    assert cfg.data.batch_size == 8 and cfg.niters_per_epoch == 20
    assert cfg.data.num_classes == 8 and cfg.eval_every == 1


def test_jax_columns_equal_miou_md():
    text = open(os.path.join(REPO, "MIOU.md")).read()
    for column, vals in miou_study.JAX_VAL_MIOU.items():
        block = text.split(f"## tpu / {column} (tpu)")[1].split("\n## ")[0]
        rows = re.findall(r"^\| (\d+) \| (\d+) \| [\d.]+ \| ([\d.]+) \|$",
                          block, re.M)
        assert [float(v) for _, _, v in rows] == list(vals), column
        for _, step, v in rows:
            assert miou_study.jax_val_miou(column, int(step)) == float(v)
    assert miou_study.jax_val_miou("student8", 180) is None


def test_tiny_study_writes_jax_schema_and_report(tmp_path):
    train = miou_study.render(8, "train", TINY_HW, threads=2)
    val = miou_study.render(4, "val", TINY_HW, threads=2)
    assert train[0]["data"].shape == (*TINY_HW, 3)
    paths, written = {}, []
    for stage in ("teacher", "student"):
        cfg = miou_study.study_config(stage, hw=TINY_HW, batch=4, niters=2)
        paths[stage] = str(tmp_path / f"{stage}_ckpt")
        seen = []
        rows, _ = miou_study.run_stage(
            stage, 2, train, val, teacher_ckpt=paths.get("teacher"),
            out=paths[stage], log=str(tmp_path / f"torch_{stage}.jsonl"),
            cfg=cfg, device="cpu", on_row=seen.append)
        assert seen == rows and [r["step"] for r in rows] == [2, 4]
        for r in rows:
            assert JAX_ROW_KEYS <= set(r)
            assert r["side"] == "torch" and r["stage"] == stage
            assert r["backend"] == "cpu" and r["gpu"] is None
            assert 0.0 <= r["val_mIoU"] <= 1.0 and r["loss"] > 0
        assert os.path.isfile(paths[stage])
        written += rows
    back = miou_study.read_rows(str(tmp_path))
    order = lambda rs: sorted(rs, key=lambda r: (r["stage"], r["step"]))
    assert order(back) == order(json.loads(json.dumps(written)))
    text = miou_study.report(back)
    assert "## torch / teacher (cpu)" in text
    assert "## torch / student (cpu)" in text
    assert text.count("| 2 |") == 2 and text.count("| 4 |") == 2

    # the int8 check on that student, through the plain versions here
    plan, net = int8_check.load_student(paths["student"])
    res, qvars, runner, maps = int8_check.check(plan, net, val,
                                                device="cpu")
    assert res["images"] == 4 and res["hw"] == list(TINY_HW)
    assert set(maps) == {"bf16", "int8", "fp32", "int8_fp32", "bf16_plain",
                         "int8_plain"}
    assert res["classmap_agreement_pct"] == int8_check.agreement_pct(
        maps["int8"], maps["bf16"])
    jax = res["jax_arithmetic"]
    assert jax["classmap_agreement_pct"] == int8_check.agreement_pct(
        maps["int8_plain"], maps["bf16_plain"])
    assert jax["bf16_vs_f32_agreement_pct"] == int8_check.agreement_pct(
        maps["bf16_plain"], maps["fp32"])
    assert set(int8_check.acceptance(jax)) == {
        "agreement_floor_pct", "agreement_met", "delta_met"}
    x = int8_check.inputs(val[:1], "cpu")[0]
    assert torch.equal(runner.classmap(x)[0], maps["int8"][0])
    assert all(qvars["params_q"][k].dtype == torch.int8
               for k in qvars["params_scale"])
    for k in ("classmap_agreement_pct", "bf16_vs_f32_agreement_pct",
              "int8_vs_int8_fp32_plain_pct"):
        assert 0.0 <= res[k] <= 100.0
    assert res["mIoU_delta_points"] == pytest.approx(
        100 * (res["mIoU_int8"] - res["mIoU_bf16"]))
    # no kernel launches on the CPU
    assert all(n == 0 for counts in res["launches"].values()
               for n in counts.values())
    assert res["qvars_bytes"] < res["fp32_state_dict_bytes"] / 3
    assert isinstance(int8_check.failures(res), list)


def test_int8_acceptance_matches_jax_rule():
    """scripts/int8_check.py:140-142: agreement >= max(min(99.9, bf16 vs
    fp32 - 0.05), 99.5), |delta mIoU| < 0.2 points."""
    ok = {"classmap_agreement_pct": 99.9, "bf16_vs_f32_agreement_pct": 99.99,
          "mIoU_delta_points": 0.19}
    assert int8_check.failures(ok) == []
    assert int8_check.acceptance(ok) == {"agreement_floor_pct": 99.9,
                                         "agreement_met": True,
                                         "delta_met": True}
    assert int8_check.failures({**ok, "classmap_agreement_pct": 99.89})
    assert int8_check.failures({**ok, "mIoU_delta_points": -0.2})
    # a noisy bf16 path lowers the floor to its own agreement - 0.05 ...
    low = {**ok, "bf16_vs_f32_agreement_pct": 99.6,
           "classmap_agreement_pct": 99.56}
    assert int8_check.failures(low) == []
    # ... but never below 99.5
    assert int8_check.failures({**low, "bf16_vs_f32_agreement_pct": 99.0,
                                "classmap_agreement_pct": 99.49})


def test_entry_points_default_to_cuda():
    import inspect
    for fn in (miou_study.run_stage, int8_check.check):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            int8_check.main(["--ckpt", "unused"])
