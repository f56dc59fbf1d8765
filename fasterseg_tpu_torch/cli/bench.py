"""CLI: the headline benchmark, student inference FPS at 1024x2048, batch 1.

Counterpart of the repo's bench.py: the decoded shipped student (arch_1,
lasts [2, 1]) with the JAX bench's own draw of weights
(`create_derived(plan, PRNGKey(0))`, here `utils/weights.init_jax_draw_`),
in eval mode, bf16 compute, served by `InferenceRunner` through the conv
kernels and the fused upsample-argmax. Baseline: 163.9 FPS on a GTX 1080Ti
with TensorRT 5.1.5 (BASELINE.md).

The input is a (1, H, W, 3) standard-normal image drawn from seed 1 by the
JAX package's threefry (`utils/prng.normal`) in fp32 and then cast to bf16;
JAX's bench draws it in bf16 directly, so the two images are not bit-equal.

Timing: `latency/measure.graph_slope_ms`, CUDA graphs of 2 and 12 calls
replayed under CUDA events, the slope per call (device time alone; a graph
replays every launch, so no data dependency between calls is needed):
`.logits` median of 5 slopes (`raw_minmax` spread), `.classmap` median of 9
with the extremes dropped (`trimmed`), the int8 runner's `.logits` median
of 5. `--device cpu` times the plain versions by wall clock; it exists for
the tests and reads no device.

There is one serving path and no fallback: if a call fails, the bench fails
and prints no result (bench.py falls back to its XLA body, and turns an
int8 failure into an `int8_error` key).

Prints one JSON line, the last line of its output: bench.py's keys
(`metric`, `value`, `unit`, `vs_baseline`, `spread_pct`, `spread_kind`,
`classmap_*`, `serving_path`, `int8_*`) and the port's (`gpu`, `hw`,
`dtype`, `logits_ms`, `classmap_ms`, `int8_ms`, `launches`,
`launches_by_route`, `baseline`).

  python -m fasterseg_tpu_torch.cli.bench [--no-int8]
"""

from __future__ import annotations

import argparse
import json
from typing import Tuple

import torch

from .. import kernels
from ..kernels import resolve_device
from ..latency.measure import _sync, graph_slope_ms
from ..models import DerivedNet, InferenceRunner, student_plan
from ..models.quantize import quantize_variables
from ..utils import prng
from ..utils.weights import init_jax_draw_
from .calibrate_latency import card_line

BASELINE_FPS = 163.9
BASELINE = "163.9 FPS, GTX 1080Ti + TensorRT 5.1.5 (BASELINE.md)"
HW = (1024, 2048)
# bench.py's name for its kernel stem + kernel body, the port's one path
SERVING_PATH = "fast_body"


def build(hw: Tuple[int, int] = HW, device="cuda",
          dtype: torch.dtype = torch.bfloat16):
    """The bench's (plan, net, runner, x): the shipped student with the JAX
    bench's weights (seed 0), its `InferenceRunner` in `dtype` on `device`,
    and the seed-1 image in `dtype` there."""
    device = resolve_device(device)
    plan = student_plan()
    net = init_jax_draw_(DerivedNet(plan), 0)
    runner = InferenceRunner(plan, net, dtype=dtype, device=device)
    x = torch.from_numpy(prng.normal(prng.prng_key(1), (1, *hw, 3)))
    return plan, net, runner, x.to(device=device, dtype=dtype)


def _launches(runner: InferenceRunner, x: torch.Tensor, device):
    """Kernel launches of one `.logits` and one `.classmap`, outside any
    graph (the counters are Python, so a replay adds nothing to them)."""
    _sync(device)
    kernels.reset_launch_counts()
    runner.logits(x)
    runner.classmap(x)
    _sync(device)
    return kernels.launch_counts(), kernels.route_launch_counts()


def run_bench(hw: Tuple[int, int] = HW, device="cuda", int8: bool = True
              ) -> dict:
    """bench.py's measurement through the port; the result line as a dict.
    On the card every kernel must have launched, or this raises."""
    device = resolve_device(device)
    plan, net, runner, x = build(hw, device)
    launches, routes = _launches(runner, x, device)
    if device.type == "cuda":
        idle = [k for k, n in launches.items() if n == 0]
        if idle:
            raise RuntimeError(f"bench: kernels not launched: {idle}")
    logits = lambda: runner.logits(x)
    classmap = lambda: runner.classmap(x)
    with torch.inference_mode():
        ms, spread, kind = graph_slope_ms(logits, reps=5, device=device)
        cms, cspread, ckind = graph_slope_ms(classmap, reps=9, device=device)
    result = {
        "metric": f"student_inference_fps_{hw[0]}x{hw[1]}_b1",
        "value": round(1e3 / ms, 2),
        "unit": "fps",
        "vs_baseline": round(1e3 / ms / BASELINE_FPS, 3),
        "spread_pct": round(spread, 1),
        "spread_kind": kind,
        "classmap_fps": round(1e3 / cms, 2),
        "classmap_spread_pct": round(cspread, 1),
        "classmap_spread_kind": ckind,
        "serving_path": SERVING_PATH,
    }
    if int8:
        # built after the bf16 timings, so its graphs do not share their pool
        _, qrunner = quantize_variables(plan, net, device=device)
        with torch.inference_mode():
            qms, qspread, _ = graph_slope_ms(lambda: qrunner.logits(x),
                                             reps=5, device=device)
        result.update({"int8_fps": round(1e3 / qms, 2),
                       "int8_spread_pct": round(qspread, 1),
                       "int8_serving_path": SERVING_PATH, "int8_ms": qms})
    result.update({
        "gpu": card_line() if device.type == "cuda" else "cpu",
        "hw": list(hw), "dtype": "bfloat16",
        "logits_ms": ms, "classmap_ms": cms,
        "launches": launches, "launches_by_route": routes,
        "baseline": BASELINE})
    return result


def _hw(text: str) -> Tuple[int, int]:
    h, w = (int(v) for v in text.split(","))
    return h, w


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--no-int8", action="store_true",
                   help="leave out the int8 row")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu times the plain "
                        "versions by wall clock, for tests)")
    p.add_argument("--hw", type=_hw, default=HW, metavar="H,W",
                   help="input height and width (default 1024,2048)")
    args = p.parse_args(argv)
    result = run_bench(args.hw, args.device, int8=not args.no_int8)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
