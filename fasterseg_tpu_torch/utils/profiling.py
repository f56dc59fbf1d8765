"""Tracing: the program's spans and counters, and the serving path's latency
split.

Counterpart of the JAX package's utils/profiling.py, plus the port's own
spans:

* `span(name)` / `count(name, n)` -- in-memory spans and counters at the
  stage boundaries of serving (`infer.*`), evaluation (`eval.*`), training
  (`train.*`) and the train loader (`loader.*`). They are on while a
  torch.profiler profile is active on the calling thread, or inside a
  `recording()` block. Off, `span` returns one shared no-op context and
  `count` returns at once: no allocation, no clock read, no CUDA call. On,
  a span keeps its name, start and end (`time.perf_counter_ns`), its
  parent, the unit it belongs to (the id of the outermost span open on its
  thread: one served frame, evaluation pass or training step) and its
  thread. Under the profiler a span also enters
  `torch.profiler.record_function(name)`, so it lies on the profiler's
  host timeline beside the kernels and copies it launched. The profiler
  follows only the thread that started it, so spans on other threads (the
  train loader's prefetch thread) never reach its timeline: they record
  only inside `recording()`.
  `summary()` gives each span name's count, total and self ms, the
  counters and the kernel launches (`kernels.launch_counts`) over the
  recording; `reset()` clears them;
* `trace` -- a torch.profiler context that writes a Chrome trace (kernels,
  copies, host calls and the program's spans on one timeline;
  chrome://tracing or Perfetto);
* `serving_segments` -- the serving path's stages timed by graph slope
  (latency/measure.py `graph_slope_ms`): the kernel stem, stem + cell body +
  aggregation + head (1/8 logits), full-resolution logits (+ x8 resize) and
  the class map (+ fused upsample-argmax), with the differences between them.

`trace` and `serving_segments` are driven by `python -m
fasterseg_tpu_torch.cli.profile`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import (TYPE_CHECKING, Any, Dict, Iterator, List, NamedTuple,
                    Optional, Tuple, Union)

import torch

# imported here, not in the first span: an import inside a traced window
# would read as the program's time
from .. import kernels

if TYPE_CHECKING:
    from ..core.plan import NetworkPlan

# spans kept between resets; later ones are counted as dropped
MAX_SPANS = 1 << 16

_profiler_enabled = torch._C._autograd._profiler_enabled   # this thread's
_clock = time.perf_counter_ns


class SpanRecord(NamedTuple):
    id: int
    name: str
    start_ns: int            # _clock(): time.perf_counter_ns()
    end_ns: int
    parent: Optional[int]    # id of the enclosing span on the same thread
    unit: int                # id of the outermost span open on the thread
    thread: int              # threading.get_ident()


class _Recorder:
    """The process's spans and counters, and what `recording()` turns on."""

    def __init__(self):
        self.lock = threading.Lock()
        self.active = 0          # recording() blocks open, on any thread
        self.local = threading.local()
        self.ids = itertools.count()
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.spans: List[SpanRecord] = []
            self.dropped = 0
            self.counters: Dict[str, float] = {}
            self.launch_base: Optional[Dict[str, int]] = None

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def started(self) -> None:
        """Kernel launches are counted from the first span or count after a
        reset."""
        if self.launch_base is None:
            with self.lock:
                if self.launch_base is None:
                    self.launch_base = kernels.launch_counts()

    def add(self, rec: SpanRecord) -> None:
        with self.lock:
            if len(self.spans) < MAX_SPANS:
                self.spans.append(rec)
            else:
                self.dropped += 1


_REC = _Recorder()


class _Off:
    """The shared context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "unit", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _REC.started()
        st = _REC.stack()
        self.id = next(_REC.ids)
        self.parent = st[-1].id if st else None
        self.unit = st[-1].unit if st else self.id
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        st.append(self)
        self.start = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = _clock()
        _REC.stack().pop()
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        _REC.add(SpanRecord(self.id, self.name, self.start, end, self.parent,
                            self.unit, threading.get_ident()))
        return None


def span(name: str):
    """A context that records the `with` body as span `name` while tracing
    is on (module docstring), and does nothing otherwise."""
    if _REC.active or _profiler_enabled():
        return _Span(name)
    return _OFF


def count(name: str, n: float = 1) -> None:
    """Add `n` to counter `name` while tracing is on."""
    if _REC.active or _profiler_enabled():
        _REC.started()
        with _REC.lock:
            _REC.counters[name] = _REC.counters.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Turn spans and counters on, on every thread, for the `with` body,
    without the profiler's cost. What was recorded stays until `reset()`."""
    with _REC.lock:
        _REC.active += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.active -= 1


def reset() -> None:
    """Clear the spans, the counters and the launch baseline."""
    _REC.reset()


def spans() -> List[SpanRecord]:
    """The spans recorded since the last reset, in the order they ended."""
    with _REC.lock:
        return list(_REC.spans)


def summary() -> Dict[str, Any]:
    """{"spans": {name: {"count", "total_ms", "self_ms"}}, "counters",
    "launches", "dropped"}: self ms is a span's duration less what its
    children cover; launches are the kernel launches since the first span
    or count after the last reset."""
    with _REC.lock:
        recs = list(_REC.spans)
        counters = dict(_REC.counters)
        dropped = _REC.dropped
        base = _REC.launch_base
    child_ns: Dict[int, int] = {}
    for r in recs:
        if r.parent is not None:
            child_ns[r.parent] = (child_ns.get(r.parent, 0)
                                  + r.end_ns - r.start_ns)
    by_name: Dict[str, Dict[str, float]] = {}
    for r in recs:
        d = by_name.setdefault(r.name, {"count": 0, "total_ms": 0.0,
                                        "self_ms": 0.0})
        dur = r.end_ns - r.start_ns
        d["count"] += 1
        d["total_ms"] += dur * 1e-6
        d["self_ms"] += (dur - child_ns.get(r.id, 0)) * 1e-6
    now = kernels.launch_counts()
    launches = {k: v - (base or now).get(k, 0) for k, v in now.items()}
    return {"spans": by_name, "counters": counters, "launches": launches,
            "dropped": dropped}


@contextlib.contextmanager
def trace(logdir: str, device: Union[str, torch.device] = "cuda"
          ) -> Iterator[torch.profiler.profile]:
    """Profile the body of the `with` (host calls and the program's spans,
    and the card's kernels and copies where `device` is a card) and write it
    as a Chrome trace `trace_<pid>.json` under `logdir`."""
    from ..kernels import resolve_device
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


def serving_segments(plan: "NetworkPlan", net: torch.nn.Module,
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
    from ..kernels import resolve_device
    from ..latency.measure import graph_slope_ms
    from ..models.infer import InferenceRunner, fast_stem
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
