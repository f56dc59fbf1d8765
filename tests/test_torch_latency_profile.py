"""The port's profiling (utils/profiling.py, cli/profile.py) and the
calibration CLI, run end to end on the CPU at 64x128 (timings there are of
the plain versions and only the structure is checked), mirroring
tests/test_profiling.py."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from fasterseg_tpu_torch.cli import calibrate_latency
from fasterseg_tpu_torch.cli import profile as profile_cli
from fasterseg_tpu_torch.latency import LatencyLUT, derived_latency_ms
from fasterseg_tpu_torch.models import DerivedNet, student_plan
from fasterseg_tpu_torch.utils.profiling import serving_segments, trace
from fasterseg_tpu_torch.utils.weights import init_random_
from _torch_search_common import few_threads, standin_ms  # noqa: F401

HW = (64, 128)


def test_serving_segments_keys_and_consistency():
    plan = student_plan()
    net = init_random_(DerivedNet(plan), 0)
    row = serving_segments(plan, net, input_hw=HW, dtype=torch.float32,
                           device="cpu", reps=1, n1=1, n2=2)
    for k in ("stem_ms", "body_agg_ms", "upsample_ms", "classmap_head_ms",
              "p8_ms", "logits_ms", "classmap_ms", "logits_fps",
              "classmap_fps"):
        assert np.isfinite(row[k]), k
    for k in ("stem_ms", "p8_ms", "logits_ms", "classmap_ms"):
        assert row[k] >= 1e-3, k         # slopes are floored
    total = row["stem_ms"] + row["body_agg_ms"] + row["upsample_ms"]
    assert total == pytest.approx(row["logits_ms"], rel=1e-12)
    assert row["classmap_ms"] == pytest.approx(
        row["p8_ms"] + row["classmap_head_ms"], rel=1e-12)
    assert row["logits_fps"] == pytest.approx(1e3 / row["logits_ms"])


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir, device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    found = glob.glob(os.path.join(logdir, "trace_*.json"))
    assert found
    with open(found[0]) as f:
        assert json.load(f)["traceEvents"]


def test_profile_cli_counts_equal_jax(tmp_path):
    import jax
    from fasterseg_tpu.models import student_plan as jax_student
    from fasterseg_tpu.models.derived import DerivedNet as JaxNet
    from fasterseg_tpu.utils.flops import param_count, plan_flops
    row = profile_cli.main(["--device", "cpu", "--height", "64", "--width",
                            "128", "--dtype", "float32", "--trace",
                            str(tmp_path / "t")])
    plan = jax_student()
    shapes = jax.eval_shape(lambda: JaxNet(plan=plan).init(
        jax.random.PRNGKey(0), np.zeros((1, *HW, 3), np.float32),
        train=True))
    assert row["gflops"] == pytest.approx(plan_flops(plan, HW) / 1e9,
                                          rel=1e-12)
    assert row["mparams"] == pytest.approx(
        param_count(shapes["params"]) / 1e6, rel=1e-12)
    assert row["network"] == "student" and row["input_hw"] == list(HW)
    assert row["logits_ms"] >= 1e-3 and glob.glob(str(tmp_path / "t" / "*"))


def test_calibrate_cli_end_to_end_on_cpu(tmp_path):
    """Measure the four plans, fit, apply, and refit from the written rows;
    on a stand-in table at 64x128."""
    path = str(tmp_path / "lut.json")
    lut = LatencyLUT(path, provider=standin_ms)
    plans = calibrate_latency.shipped_plans()
    for plan in plans.values():
        derived_latency_ms(lut, plan, HW)
    args = ["--lut", path, "--device", "cpu", "--height", "64", "--width",
            "128", "--reps", "1"]
    out = calibrate_latency.main(args + ["--apply"])
    calib_path = calibrate_latency.calibration_path(path)
    assert json.load(open(calib_path))["plans"] == out["plans"]
    assert set(out["plans"]) == set(plans) and out["card"] == "cpu"
    fitted = LatencyLUT(path)
    assert fitted.fusion_factor == out["fusion_factor"]
    for name, row in out["plans"].items():
        assert row["ratio"] == pytest.approx(row["measured_ms"]
                                             / row["walk_ms"])
        est = derived_latency_ms(fitted, plans[name], HW)
        # fit_factors' error: |measured / estimate - 1| of each row
        assert abs(row["measured_ms"] / est - 1.0) <= \
            out["max_rel_err_pct"] / 100 * (1 + 1e-9) + 1e-12
    again = calibrate_latency.main(args + ["--refit"])
    assert again["fusion_factor_by_width"] == out["fusion_factor_by_width"]
