"""The port's latency CLIs and estimates against the JAX package's, on the
CPU: the LUT sweep's key set (both CLIs with stand-in providers), its
resumption and budget; the FPS band, FLOPs, parameter counts and
run_latency's LUT estimate; the calibration fit against
scripts/calibrate_latency.py on the same rows; the committed H100 table and
its calibration from the checkout alone; `--fps-band auto`; the width-family
warning of `factor_for`.
"""

import json
import os
import runpy
import shutil
import sys
import warnings

import jax
import numpy as np
import pytest

from fasterseg_tpu_torch.cli import calibrate_latency
from fasterseg_tpu_torch.latency import (LatencyLUT, derived_latency_ms,
                                         fps_band, h100_lut)
from fasterseg_tpu_torch.latency.lut import H100_LUT
from _torch_search_common import few_threads, standin_ms  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5E_LUT = os.path.join(REPO, "latency_lut_v5e.json")
CALIB = calibrate_latency.calibration_path(H100_LUT)
HW = (1024, 2048)
SMALL = ("--height", "64", "--width", "128")


class _Counting:
    def __init__(self):
        self.calls = []

    def __call__(self, name):
        self.calls.append(name)
        return standin_ms(name)


def _port_sweep(path, monkeypatch, *extra):
    from fasterseg_tpu_torch.cli import latency_lut
    from fasterseg_tpu_torch.latency import measure
    stub = _Counting()
    monkeypatch.setattr(measure, "measured_provider", lambda **kw: stub)
    lut = latency_lut.main(["--out", str(path), *SMALL, *extra])
    return lut, stub


def test_sweep_keys_equal_the_jax_cli(tmp_path, monkeypatch):
    import fasterseg_tpu.latency.measure as jm
    import fasterseg_tpu.utils.logging as jl
    from fasterseg_tpu.cli import latency_lut as jax_cli
    monkeypatch.setattr(jl, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(jm, "measured_provider",
                        lambda dtype=None, **kw: standin_ms)
    want = jax_cli.main(["--out", str(tmp_path / "jax.json"), *SMALL])
    got, stub = _port_sweep(tmp_path / "port.json", monkeypatch)
    assert len(got) > 700
    assert set(got.table) == set(want.table)
    assert len(stub.calls) == len(set(stub.calls)) == len(got)
    assert json.load(open(tmp_path / "port.json")) == got.table


def test_sweep_resumes_and_stops_at_its_budget(tmp_path, monkeypatch):
    path = tmp_path / "lut.json"
    first, stub = _port_sweep(path, monkeypatch, "--max-entries", "25")
    assert len(stub.calls) == 25 and len(first) == 25
    assert len(json.load(open(path))) == 25
    rest, stub = _port_sweep(path, monkeypatch)
    assert not set(stub.calls) & set(first.table)
    total = len(rest)
    assert len(stub.calls) == total - 25
    again, stub = _port_sweep(path, monkeypatch)
    assert stub.calls == [] and len(again) == total


def _plans():
    from fasterseg_tpu.models import student_plan as jax_student
    from fasterseg_tpu.models import teacher_plan as jax_teacher
    from fasterseg_tpu_torch.models import student_plan, teacher_plan
    return {"student": (student_plan(), jax_student()),
            "teacher": (teacher_plan(), jax_teacher())}


def test_band_flops_params_and_estimate_equal_jax():
    from fasterseg_tpu.latency import LatencyLUT as JaxLUT
    from fasterseg_tpu.latency import derived_latency_ms as jax_walk
    from fasterseg_tpu.latency.derived import tpu_fps_band
    from fasterseg_tpu.models.derived import DerivedNet as JaxNet
    from fasterseg_tpu.utils.flops import param_count as jax_params
    from fasterseg_tpu.utils.flops import plan_flops as jax_flops
    from fasterseg_tpu_torch.cli.run_latency import lut_estimate_ms
    from fasterseg_tpu_torch.models import DerivedNet
    from fasterseg_tpu_torch.utils.flops import param_count, plan_flops
    plans = _plans()
    port_s, jax_s = plans["student"]
    for path in (H100_LUT, V5E_LUT):
        got = fps_band(LatencyLUT(path), port_s)
        want = tpu_fps_band(JaxLUT(path), jax_s)
        assert got == pytest.approx(want, rel=1e-9)
    for name, (port_plan, jax_plan) in plans.items():
        for hw in (HW, (64, 128)):
            assert plan_flops(port_plan, hw) == jax_flops(jax_plan, hw)
        shapes = jax.eval_shape(
            lambda: JaxNet(plan=jax_plan).init(
                jax.random.PRNGKey(0), np.zeros((1, 64, 128, 3), np.float32),
                train=True))
        assert param_count(DerivedNet(port_plan)) == jax_params(
            shapes["params"])
        assert lut_estimate_ms(port_plan) == pytest.approx(
            jax_walk(JaxLUT(H100_LUT), jax_plan, HW), rel=1e-9)
    # the student's FLOPs: 28 GMACs in the paper (PARITY.md)
    assert plan_flops(port_s, HW) / 2e9 == pytest.approx(28, rel=0.1)


def test_run_latency_cli_on_cpu(tmp_path):
    """run_latency at 64x128 on the CPU: its LUT estimate equals the JAX
    walk on the same table, and every reading is there."""
    from fasterseg_tpu.latency import LatencyLUT as JaxLUT
    from fasterseg_tpu.latency import derived_latency_ms as jax_walk
    from fasterseg_tpu_torch.cli import run_latency
    port_s, jax_s = _plans()["student"]
    path = str(tmp_path / "lut.json")
    lut = LatencyLUT(path, provider=standin_ms)
    derived_latency_ms(lut, port_s, (64, 128))
    row = run_latency.main(["--device", "cpu", "--lut", path, *SMALL])
    assert row["lut_estimate_ms"] == pytest.approx(
        jax_walk(JaxLUT(path), jax_s, (64, 128)), rel=1e-9)
    assert row["lasts"] == list(port_s.lasts) and row["dtype"] == "bfloat16"
    assert row["input"] == "64x128" and row["device"] == "cpu"
    for what in ("logits", "classmap"):
        for k in (f"{what}_ms", f"{what}_call_ms"):
            assert np.isfinite(row[k]) and row[k] >= 1e-3
        assert row[f"{what}_fps"] == pytest.approx(1e3 / row[f"{what}_ms"])


def test_calibration_fit_equals_the_script(tmp_path, monkeypatch):
    """The port's fit on the committed H100 rows against
    scripts/calibrate_latency.py --refit on the same rows (run from a copy
    of the script, so nothing of the checkout is written)."""
    with open(CALIB) as f:
        rows = json.load(f)["plans"]
    (tmp_path / "scripts").mkdir()
    shutil.copy(os.path.join(REPO, "scripts", "calibrate_latency.py"),
                tmp_path / "scripts")
    (tmp_path / "tests").mkdir()
    os.symlink(os.path.join(REPO, "tests", "assets"),
               tmp_path / "tests" / "assets")
    evid = tmp_path / "evidence" / "latency_calib"
    evid.mkdir(parents=True)
    with open(evid / "calibration.json", "w") as f:
        json.dump({"plans": rows}, f)
    import fasterseg_tpu.utils.logging as jl
    monkeypatch.setattr(jl, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["calibrate_latency.py", "--refit"])
    runpy.run_path(str(tmp_path / "scripts" / "calibrate_latency.py"),
                   run_name="__main__")
    want = json.load(open(evid / "calibration.json"))
    widths = {n: p.stem_head_width[0]
              for n, p in calibrate_latency.shipped_plans().items()}
    factor, factors, max_err = calibrate_latency.fit_factors(rows, widths)
    assert factor == pytest.approx(want["fusion_factor"], abs=1e-6)
    assert {repr(w): f for w, f in factors.items()} == pytest.approx(
        want["fusion_factor_by_width"], abs=1e-6)
    assert max_err * 100 == pytest.approx(want["max_rel_err_pct"], abs=5e-3)


def test_committed_h100_table_and_calibration():
    """From the checkout alone: the table covers the supernet tables, both
    stems and the four shipped walks at 1024x2048 with no miss, reproduces
    each plan's recorded raw walk and puts the calibrated walk within 10 %
    of the recorded measured ms (the bar of test_latency_calibration.py),
    and says which card measured it."""
    from fasterseg_tpu_torch.core.config import WIDTH_MULT_LIST
    from fasterseg_tpu_torch.latency import (build_supernet_tables,
                                             stem_latency_ms)
    calib = json.load(open(CALIB))
    assert "H100" in calib["card"] and " W" in calib["card"]
    assert calib["input_hw"] == list(HW) and calib["dtype"] == "bfloat16"

    def miss(name):
        raise KeyError(name)

    lut = h100_lut(provider=miss)
    assert lut.path is None and len(lut) > 700
    tables = build_supernet_tables(lut, 16, 12, WIDTH_MULT_LIST, HW)
    assert all(np.isfinite(t).all() for t in tables.values())
    for sw in (1.0, 8.0 / 12):
        assert stem_latency_ms(lut, 12, sw, HW) > 0
    assert lut.fusion_factor == pytest.approx(calib["fusion_factor"])
    for w, f in calib["fusion_factor_by_width"].items():
        assert lut.factor_for(float(w)) == pytest.approx(f)
    plans = calibrate_latency.shipped_plans()
    assert set(calib["plans"]) == set(plans)
    for name, row in calib["plans"].items():
        raw = derived_latency_ms(lut, plans[name], HW, calibrate=False)
        assert raw == pytest.approx(row["walk_ms"], rel=1e-3)
        est = derived_latency_ms(lut, plans[name], HW)
        assert abs(est / row["measured_ms"] - 1.0) < 0.10, name


def test_train_search_auto_band_on_a_table(tmp_path, monkeypatch):
    """`--fps-band auto` sets the band from the LUT in use (`--lut`, else
    the reference's table) and the shipped student, as the JAX CLI's
    `tpu_fps_band` does; the search itself is stubbed out."""
    from fasterseg_tpu.latency import LatencyLUT as JaxLUT
    from fasterseg_tpu.latency.derived import tpu_fps_band
    from fasterseg_tpu.models import student_plan as jax_student
    import fasterseg_tpu_torch.search as search
    from fasterseg_tpu_torch.cli import train_search
    from fasterseg_tpu_torch.latency import reference_lut
    from fasterseg_tpu_torch.models import student_plan
    seen = {}
    monkeypatch.setattr(search, "run_search",
                        lambda cfg, **kw: seen.update(cfg=cfg, **kw))
    args = ["--synthetic", "--fps-band", "auto", "--device", "cpu",
            "--save", str(tmp_path)]
    train_search.main(args + ["--lut", H100_LUT])
    band = (seen["cfg"].fps_min[-1], seen["cfg"].fps_max[-1])
    assert seen["lut"].path == H100_LUT
    assert band == pytest.approx(
        tpu_fps_band(JaxLUT(H100_LUT), jax_student()), rel=1e-9)
    assert band == pytest.approx(fps_band(h100_lut(), student_plan()),
                                 rel=1e-12)
    train_search.main(args)
    band = (seen["cfg"].fps_min[-1], seen["cfg"].fps_max[-1])
    assert seen["lut"] is None
    assert band == pytest.approx(fps_band(reference_lut(), student_plan()),
                                 rel=1e-12)


def test_factor_for_warns_far_from_every_family():
    from fasterseg_tpu.latency import LatencyLUT as JaxLUT
    port, ref = LatencyLUT(), JaxLUT()
    port.fusion_factors = ref.fusion_factors = {1.0: 0.6, 0.6667: 0.37}
    for width in np.linspace(0.0, 1.6, 33):
        far = min(abs(width - k) for k in port.fusion_factors) > 0.1
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = port.factor_for(width)
        assert got == ref.factor_for(width)
        assert bool(caught) == far, width
    with pytest.warns(UserWarning, match="calibrated family"):
        port.factor_for(0.3)
