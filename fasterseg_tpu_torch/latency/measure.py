"""Latency measurement on the card: timing harnesses and the LUT provider.

Counterpart of the JAX package's latency/measure.py, itself the
counterpart of the reference's TensorRT timers (tools/utils/darts_utils.py:
96-223) and measure-on-miss (search/operations.py:115-123).

* `time_fn` times calls issued one after another by the host, as a caller
  sees them (`time_jitted` / `measure_apply_ms`).
* `graph_slope_ms` times the device alone: CUDA graphs of n1 and n2 calls,
  replayed under CUDA events; the slope per call removes the replay's fixed
  cost (`slope_time_ms` / `chained_slope_ms`).
* `measured_provider` prices a LUT key by building that op with seeded
  random weights and timing it through the port's serving route (the conv
  kernels, the fp32 1x1 products and the matrix resizes of
  models/fast_body.py), on weights folded and packed once, as
  `InferenceRunner` holds them.

On `device="cpu"` the harnesses time the plain versions by wall clock; that
exists for the tests and reads no device.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import torch

from ..kernels import resolve_device
from ..kernels.conv import conv3x3_bn_relu
from ..models.fast_body import (conv1x1, fold1x1, fold3x3, fold_cell,
                                run_cell, to_device)
from ..ops.conv import ConvNorm
from ..ops.primitives import make_op
from ..ops.seg_heads import FeatureFusion, Head
from ..utils.weights import init_random_
from .lut import OP_TRUE_NAMES, parse_key

Device = Union[str, torch.device]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn: Callable[[], object], warmup: int = 10,
            min_seconds: float = 0.5, max_iters: int = 100_000,
            device: Device = "cuda") -> float:
    """Milliseconds per call of `fn`, calls issued back to back by the host
    (the host's time between launches is counted when it paces the card).
    After `warmup` calls, batches of calls run under CUDA events (a wall
    clock on the CPU) until `min_seconds` have passed."""
    device = resolve_device(device)
    for _ in range(max(1, warmup)):
        fn()
    _sync(device)
    done, elapsed_ms, batch = 0, 0.0, 10
    while True:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(batch):
                fn()
            end.record()
            end.synchronize()
            elapsed_ms += start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(batch):
                fn()
            elapsed_ms += (time.perf_counter() - t0) * 1e3
        done += batch
        if elapsed_ms >= min_seconds * 1e3 or done >= max_iters:
            return elapsed_ms / done
        per_call = elapsed_ms / done
        batch = max(10, min(int((min_seconds * 1e3 - elapsed_ms) / per_call)
                            + 1, max_iters - done))


def _graph_of(fn: Callable[[], object], n: int, pool=None):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        for _ in range(n):
            fn()
    return graph


def _replay_ms(graph) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _wall_ms(fn: Callable[[], object], n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3


def graph_slope_ms(fn: Callable[[], object], n1: int = 2, n2: int = 12,
                   reps: int = 5, floor_ms: float = 1e-3,
                   device: Device = "cuda") -> Tuple[float, float, str]:
    """Device milliseconds per call of `fn` by the slope method: one CUDA
    graph of `n1` calls and one of `n2`, each replay timed by CUDA events;
    slope = (t(n2) - t(n1)) / (n2 - n1), which drops the replay's fixed
    cost. `fn` runs once before either capture (the conv's split-K counters
    are allocated at its first launch, and capture refuses that).

    A graph replays every recorded launch whether or not its output is
    read, so no data dependency between calls is needed (the JAX harness
    chains an additive carry to keep XLA from dropping work).

    Returns (median over `reps` slopes, spread in % of it, spread kind),
    as the JAX package's `chained_slope_ms`: with reps >= 7 the extreme
    slopes are dropped first. The median is floored at
    `floor_ms`, so a noisy slope never reads as zero or negative. The two
    graphs share one memory pool and are freed on return."""
    if n2 <= n1 or n1 < 1:
        raise ValueError(f"need 1 <= n1 < n2, got {n1}, {n2}")
    device = resolve_device(device)
    fn()
    if device.type == "cuda":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize(device)
        g1 = _graph_of(fn, n1)
        g2 = _graph_of(fn, n2, pool=g1.pool())
        _replay_ms(g1), _replay_ms(g2)
        timed = lambda n: _replay_ms(g1 if n == n1 else g2)
    else:
        timed = lambda n: _wall_ms(fn, n)
    slopes = []
    for _ in range(reps):
        t1 = timed(n1)
        t2 = timed(n2)
        slopes.append((t2 - t1) / (n2 - n1))
    slopes.sort()
    kind = "raw_minmax"
    if reps >= 7:
        slopes = slopes[1:-1]
        kind = "trimmed"
    med = max(statistics.median(slopes), floor_ms)
    spread = (slopes[-1] - slopes[0]) / med * 100.0
    return med, spread, kind


# ------------------------------------------------------------- LUT provider

_OP_INDEX = {n: i for i, n in enumerate(OP_TRUE_NAMES)}


@dataclass
class KeyOp:
    """The module a LUT key prices and the input it takes.

    kind: "op" (a searchable primitive, `index` 0-4), "ConvNorm", "ff" or
    "head"; shape: the NHWC input (1, H, W, Cin). `module` is None for the
    identity skip (op 0 at stride 1), which computes nothing."""
    kind: str
    module: Optional[torch.nn.Module]
    shape: Tuple[int, int, int, int]
    stride: int = 1
    index: int = -1
    kernel: int = 3


def build_key(name: str) -> KeyOp:
    """Parse a key and build the port's module for it (fp32, default init).
    Alias keys build the aliased op (op 4 priced under the BasicResidual2x
    key is op 3), as in the JAX provider."""
    op, f = parse_key(name)
    h, w = f["H"], f["W"]
    stride = f.get("stride", 1)
    if op == "ConvNorm":
        k = f.get("kernel", 3)
        if k not in (1, 3) or (k == 1 and stride != 1):
            raise KeyError(f"no serving route for key: {name}")
        m = ConvNorm(f["Cin"], f["Cout"], kernel_size=k, stride=stride,
                     padding=k // 2)
        return KeyOp(op, m.eval(), (1, h, w, f["Cin"]), stride, kernel=k)
    if op == "ff":
        return KeyOp(op, FeatureFusion(f["C"], f["C"]).eval(),
                     (1, h, w, f["C"]))
    if op == "head":
        return KeyOp(op, Head(f["Cin"], f["Cout"]).eval(),
                     (1, h, w, f["Cin"]))
    if op in _OP_INDEX:
        idx = _OP_INDEX[op]
        module = None
        if not (idx == 0 and stride == 1):   # identity (operations.py:533)
            module = make_op(idx, f["Cin"], f["Cout"], stride).eval()
        return KeyOp("op", module, (1, h, w, f["Cin"]), stride, idx)
    raise KeyError(f"cannot build module for key: {name}")


@torch.no_grad()
def serving_route(op: KeyOp, device: Device = "cuda",
                  dtype: torch.dtype = torch.bfloat16
                  ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """`op`'s forward as the serving path runs it (models/fast_body.py), on
    NHWC input of `dtype`, with the weights folded and packed once for it
    and moved to `device`; None for the identity skip. On a CUDA tensor
    every 3x3 conv launches the conv kernel; on a CPU tensor the plain
    versions run."""
    device = resolve_device(device)
    m = op.module
    if m is None:
        return None
    if op.kind == "op":
        p = to_device(fold_cell(m, dtype), device)
        idx, stride = op.index, op.stride
        return lambda x: run_cell(idx, x, p, stride)
    if op.kind == "ConvNorm":
        conv, bn = m.conv[0], m.conv[1]
        if op.kernel == 1:
            p1 = to_device(fold1x1(conv, bn), device)
            return lambda x: conv1x1(x, p1)
        p3 = to_device(fold3x3(conv, bn, dtype=dtype), device)
        stride = op.stride
        return lambda x: conv3x3_bn_relu(x, *p3, stride=stride)
    if op.kind == "ff":
        p1 = to_device(fold1x1(m.conv_1x1.conv, m.conv_1x1.bn), device)
        return lambda x: conv1x1(x, p1)
    if op.kind == "head":
        p3 = to_device(fold3x3(m.conv_3x3.conv, m.conv_3x3.bn, dtype=dtype),
                       device)
        cls = to_device(fold1x1(m.conv_1x1, None), device)
        return lambda x: conv1x1(conv3x3_bn_relu(x, *p3), cls, relu=False)
    raise KeyError(op.kind)


def measured_provider(dtype: torch.dtype = torch.bfloat16,
                      device: Device = "cuda", n1: int = 8, n2: int = 40,
                      reps: int = 3, floor_ms: float = 1e-3,
                      verbose: bool = True) -> Callable[[str], float]:
    """A `LatencyLUT` provider that measures: parse the key, build the op
    with random weights (`init_random_`, seed 0), fold and pack them once,
    and time the serving route by `graph_slope_ms` on a random input (seed
    0) at batch 1 in `dtype`. The identity skip reads `floor_ms`.

    On the card nothing falls back: a conv shape the kernel cannot plan or
    launch raises. Each key's graphs are freed before the next key."""
    device = resolve_device(device)

    def provider(name: str) -> float:
        op = build_key(name)
        ms = floor_ms
        if op.module is not None:
            init_random_(op.module, 0)
            fn = serving_route(op, device, dtype)
            g = torch.Generator().manual_seed(0)
            x = torch.randn(op.shape, generator=g).to(device=device,
                                                      dtype=dtype)
            with torch.inference_mode():
                ms, _, _ = graph_slope_ms(lambda: fn(x), n1, n2, reps,
                                          floor_ms, device=device)
        if verbose:
            print(f"  measured {name} = {ms:.4f} ms", flush=True)
        return ms

    return provider
