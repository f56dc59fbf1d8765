"""CLI: end-to-end latency and FPS of a decoded network on the card.

Counterpart of the JAX package's cli/run_latency.py (the reference's
`python latency/run_latency.py`, run_latency.py:28-82): decode the genotype,
build the network with random weights (seed 0), serve it through
`InferenceRunner` (the conv kernels, the fused upsample-argmax) at batch 1,
and print one JSON line:

* `logits_ms` / `classmap_ms` and their FPS: device time by graph slope
  (latency/measure.py `graph_slope_ms`, CUDA graphs of 1 and 6 forwards);
* `logits_call_ms` / `classmap_call_ms` and their FPS: calls issued one
  after another by the host (`time_fn`), host included;
* `lut_estimate_ms` and its FPS: the derived walk on `--lut` (default: the
  table measured on an H100, latency/h100_lut.json), calibrated;
* `input`, `dtype`, `lasts`.

There is one serving path: if it fails, the CLI fails (the JAX CLI falls
back to its XLA body).

  python -m fasterseg_tpu_torch.cli.run_latency --arch tests/assets/arch_1.npz
"""

from __future__ import annotations

import argparse
import json
import os


def lut_estimate_ms(plan, lut_path=None, input_hw=(1024, 2048),
                    provider=None) -> float:
    """The calibrated derived walk of `plan` on the table at `lut_path`
    (default: the H100 table, read-only)."""
    from ..latency import LatencyLUT, derived_latency_ms, h100_lut
    lut = (LatencyLUT(lut_path, provider=provider) if lut_path
           else h100_lut(provider=provider))
    return derived_latency_ms(lut, plan, input_hw)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default=None,
                   help="arch npz/pt (default: shipped student genotype)")
    p.add_argument("--teacher", action="store_true",
                   help="decode as teacher (ignore_skip, full width)")
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--lut", default=None,
                   help="latency LUT json (default: the H100 table, "
                        "fasterseg_tpu_torch/latency/h100_lut.json)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu times the plain "
                        "versions by wall clock, for tests)")
    args = p.parse_args(argv)

    import torch

    from ..core.config import WIDTH_MULT_LIST
    from ..core.genotype import decode_network
    from ..core.plan import build_plan, select_lasts
    from ..latency.measure import graph_slope_ms, measured_provider, time_fn
    from ..models import _ASSETS, DerivedNet, InferenceRunner
    from ..models.infer import resolve_device
    from ..train.driver import load_arch_any
    from ..utils.weights import init_random_

    device = resolve_device(args.device)
    if args.arch is None:
        args.arch = os.path.join(
            _ASSETS, "arch_0.npz" if args.teacher else "arch_1.npz")
    arch, metrics = load_arch_any(args.arch)
    genos = decode_network(arch, WIDTH_MULT_LIST, layers=16,
                           ignore_skip=args.teacher)
    if all(k in metrics for k in ("mIoU02", "latency02", "mIoU12",
                                  "latency12")):
        lasts = select_lasts(metrics["mIoU02"], metrics["latency02"],
                             metrics["mIoU12"], metrics["latency12"])
    else:
        lasts = [2, 1]
    shw = (1.0, 1.0) if args.teacher else (8.0 / 12, 8.0 / 12)
    plan = build_plan(genos, lasts, Fch=12, num_classes=19,
                      stem_head_width=shw)
    hw = (args.height, args.width)

    # keys missing from the table are measured on the card
    provider = (measured_provider(device=device, verbose=False)
                if device.type == "cuda" else None)
    est_ms = lut_estimate_ms(plan, args.lut, hw, provider)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    net = init_random_(DerivedNet(plan), 0)
    runner = InferenceRunner(plan, net, dtype=dtype, device=device)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, *hw, 3), generator=g).to(device=device, dtype=dtype)

    row = {"lasts": list(lasts)}
    with torch.inference_mode():
        for what, fn in (("logits", lambda: runner.logits(x)),
                         ("classmap", lambda: runner.classmap(x))):
            ms, spread, kind = graph_slope_ms(fn, n1=1, n2=6, reps=5,
                                              device=device)
            call = time_fn(fn, warmup=3, min_seconds=0.5, device=device)
            row.update({f"{what}_ms": ms, f"{what}_fps": 1e3 / ms,
                        f"{what}_spread_pct": spread,
                        f"{what}_spread_kind": kind,
                        f"{what}_call_ms": call,
                        f"{what}_call_fps": 1e3 / call})
    row.update({"lut_estimate_ms": est_ms,
                "lut_estimate_fps": 1e3 / est_ms,
                "input": f"{args.height}x{args.width}",
                "dtype": args.dtype,
                "device": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")})
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
