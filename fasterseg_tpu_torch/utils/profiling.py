"""Tracing and the serving path's latency split.

Counterpart of the JAX package's utils/profiling.py:

* `trace` -- a torch.profiler context that writes a Chrome trace (kernels,
  copies and host calls on one timeline; chrome://tracing or Perfetto);
* `serving_segments` -- the serving path's stages timed by graph slope
  (latency/measure.py `graph_slope_ms`): the kernel stem, stem + cell body +
  aggregation + head (1/8 logits), full-resolution logits (+ x8 resize) and
  the class map (+ fused upsample-argmax), with the differences between them.

Driven by `python -m fasterseg_tpu_torch.cli.profile`.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch

from ..core.plan import NetworkPlan
from ..models.infer import InferenceRunner, fast_stem, resolve_device


@contextlib.contextmanager
def trace(logdir: str, device: Union[str, torch.device] = "cuda"
          ) -> Iterator[torch.profiler.profile]:
    """Profile the body of the `with` (host calls, and the card's kernels
    and copies where `device` is a card) and write it as a Chrome trace
    `trace_<pid>.json` under `logdir`."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))


def serving_segments(plan: NetworkPlan, net: torch.nn.Module,
                     input_hw: Tuple[int, int] = (1024, 2048),
                     dtype: torch.dtype = torch.bfloat16,
                     device: Union[str, torch.device] = "cuda",
                     reps: int = 5, n1: int = 1, n2: int = 6,
                     x: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Device ms of each serving stage of `net` (a DerivedNet) through
    `InferenceRunner`: `stem_ms`, `p8_ms` (stem + body + aggregation +
    head), `logits_ms`, `classmap_ms`, and the derived `body_agg_ms` (p8 -
    stem), `upsample_ms` (logits - p8) and `classmap_head_ms` (classmap -
    p8), with both FPS. Every timed stage returns one tensor. Unrounded."""
    from ..latency.measure import graph_slope_ms
    device = resolve_device(device)
    runner = InferenceRunner(plan, net, dtype=dtype, device=device)
    if x is None:
        g = torch.Generator().manual_seed(0)
        x = torch.randn((1, *input_hw, 3), generator=g)
    x = x.to(device=device, dtype=dtype).contiguous()
    stem = runner.folded["stem"]

    def timed(fn) -> float:
        with torch.inference_mode():
            ms, _, _ = graph_slope_ms(fn, n1, n2, reps, device=device)
        return ms

    stem_ms = timed(lambda: fast_stem(stem, x))
    p8_ms = timed(lambda: runner.p8(x))
    logits_ms = timed(lambda: runner.logits(x))
    classmap_ms = timed(lambda: runner.classmap(x))
    return {"stem_ms": stem_ms,
            "body_agg_ms": p8_ms - stem_ms,
            "upsample_ms": logits_ms - p8_ms,
            "classmap_head_ms": classmap_ms - p8_ms,
            "p8_ms": p8_ms,
            "logits_ms": logits_ms,
            "classmap_ms": classmap_ms,
            "logits_fps": 1e3 / logits_ms,
            "classmap_fps": 1e3 / classmap_ms}
