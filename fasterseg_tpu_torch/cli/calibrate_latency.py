"""CLI: calibrate the derived-walk latency estimate against measured latency.

Counterpart of the JAX package's scripts/calibrate_latency.py. The FPS-band
controller of the search (search/architect.py) compares the walk's ABSOLUTE
FPS with its band, and a whole network runs faster or slower than the sum
of its ops timed alone. So this CLI

* measures `InferenceRunner.logits` at 1024x2048, bf16, batch 1 (the conv
  kernels; seeded random weights) by graph slope (latency/measure.py
  `graph_slope_ms`) for the four shipped plans: teacher and student at lasts
  [2, 0] and [2, 1];
* fits one factor per width family (the stem/head width: teacher 1.0,
  student 8/12) by the script's rule: the geometric midrange of the family's
  measured / walk ratios, which minimises the largest relative error;
* writes the rows (`walk_ms`, `measured_ms`, `ratio`), the factors and the
  card's name and power limit to a JSON beside the table
  (`<table>_calibration.json`), and with `--apply` stores the factors in the
  table (`__fusion_factor__`, `__fusion_factor_by_width__`).

  python -m fasterseg_tpu_torch.cli.calibrate_latency --apply
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
from typing import Dict, Mapping, Tuple

STUDENT_WIDTH = 8.0 / 12


def shipped_plans() -> Dict[str, object]:
    """Teacher and student x lasts [2, 0] / [2, 1] from the shipped
    genotypes, named as the JAX script names them."""
    from ..core import ArchParams
    from ..core.config import WIDTH_MULT_LIST
    from ..core.genotype import decode_network
    from ..core.plan import build_plan
    from ..models import _ASSETS
    plans = {}
    for name, npz, ignore_skip, shw in (
            ("teacher", "arch_0.npz", True, (1.0, 1.0)),
            ("student", "arch_1.npz", False, (STUDENT_WIDTH,) * 2)):
        arch = ArchParams.from_npz(os.path.join(_ASSETS, npz))
        genos = decode_network(arch, WIDTH_MULT_LIST, layers=16,
                               ignore_skip=ignore_skip)
        for lasts in ([2, 0], [2, 1]):
            plans[f"{name}_{lasts[0]}{lasts[1]}"] = build_plan(
                genos, lasts, Fch=12, num_classes=19, stem_head_width=shw)
    return plans


def fit_factors(rows: Mapping[str, Mapping[str, float]],
                widths: Mapping[str, float]
                ) -> Tuple[float, Dict[float, float], float]:
    """(scalar factor, factor per width family, largest relative error) of
    the measured / walk `ratio`s in `rows`; `widths` maps each row's name to
    its plan's stem/head width. Per family the geometric midrange of its
    ratios, rounded to 4 digits, as scripts/calibrate_latency.py fits it;
    the scalar is the student family's (the controller binds the student).
    """
    by_width: Dict[float, list] = {}
    for name, r in rows.items():
        by_width.setdefault(round(widths[name], 4), []).append(r["ratio"])
    factors = {
        w: round(math.exp((math.log(min(rs)) + math.log(max(rs))) / 2), 4)
        for w, rs in by_width.items()}
    max_err = max(abs(r["ratio"] / factors[round(widths[n], 4)] - 1.0)
                  for n, r in rows.items())
    factor = factors.get(round(STUDENT_WIDTH, 4), list(factors.values())[0])
    return factor, factors, max_err


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def calibration_path(lut_path: str) -> str:
    return os.path.splitext(lut_path)[0] + "_calibration.json"


def main(argv=None):
    from ..latency.lut import H100_LUT
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lut", default=H100_LUT,
                   help="the measured table (default: the package's H100 "
                        "table)")
    p.add_argument("--out", default=None,
                   help="calibration JSON (default: <table>_calibration"
                        ".json beside the table)")
    p.add_argument("--apply", action="store_true",
                   help="store the fitted factors in the table")
    p.add_argument("--refit", action="store_true",
                   help="refit from the rows already in --out (no device)")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu times the plain "
                        "versions by wall clock, for tests)")
    args = p.parse_args(argv)
    out_path = args.out or calibration_path(args.lut)
    hw = (args.height, args.width)

    import torch

    from ..latency import LatencyLUT, derived_latency_ms, fps_band
    from ..latency.measure import graph_slope_ms
    from ..models import DerivedNet, InferenceRunner, student_plan
    from ..kernels import resolve_device
    from ..utils.weights import init_random_

    lut = LatencyLUT(args.lut)        # no provider: a missing key raises
    plans = shipped_plans()
    widths = {n: plan.stem_head_width[0] for n, plan in plans.items()}
    if args.refit:
        with open(out_path) as f:
            previous = json.load(f)
        rows, card = previous["plans"], previous["card"]
        hw = tuple(previous["input_hw"])
    else:
        device = resolve_device(args.device)
        card = card_line() if device.type == "cuda" else "cpu"
        g = torch.Generator().manual_seed(1)
        x = torch.randn((1, *hw, 3), generator=g).to(device=device,
                                                     dtype=torch.bfloat16)
        rows = {}
        for name, plan in plans.items():
            walk = derived_latency_ms(lut, plan, hw, calibrate=False)
            net = init_random_(DerivedNet(plan), 0)
            runner = InferenceRunner(plan, net, dtype=torch.bfloat16,
                                     device=device)
            with torch.inference_mode():
                ms, spread, kind = graph_slope_ms(
                    lambda: runner.logits(x), n1=1, n2=6, reps=args.reps,
                    device=device)
            rows[name] = {"walk_ms": walk, "measured_ms": ms,
                          "ratio": ms / walk, "spread_pct": spread,
                          "spread_kind": kind}
            print(name, json.dumps(rows[name]), flush=True)
            del runner

    factor, factors, max_err = fit_factors(rows, widths)
    out = {
        "input_hw": list(hw),
        "dtype": "bfloat16",
        "measured_path": "InferenceRunner.logits (conv kernels, bf16, "
                         "batch 1), latency.measure.graph_slope_ms (CUDA "
                         "graphs of 1 and 6 forwards)",
        "plans": rows,
        "plan_widths": {n: round(w, 4) for n, w in widths.items()},
        "fusion_factor": factor,
        "fusion_factor_by_width": {repr(w): f for w, f in factors.items()},
        "max_rel_err_pct": max_err * 100.0,
        "card": card,
    }
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"fusion_factor": factor,
                      "fusion_factor_by_width": out["fusion_factor_by_width"],
                      "max_rel_err_pct": out["max_rel_err_pct"],
                      "out": out_path}))

    if args.apply:
        lut.fusion_factor = factor
        lut.fusion_factors = dict(factors)
        lut.save()
        band = fps_band(lut, student_plan(), hw)
        print(json.dumps({"applied_to": args.lut, "fps_band": list(band)}))
    return out


if __name__ == "__main__":
    main()
