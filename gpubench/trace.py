"""A device trace of a few units of work, reduced to what the readers use.

`profile` runs `unit(i)` for i in range(n) under torch.profiler (CPU and
CUDA activities) and returns a `Trace`: the host wall time of the traced
loop, the device's busy time (the union of kernel, copy and memset
intervals), the device operations by name (seconds, count) and the idle
gaps between busy intervals, each named by the innermost host operation
running at its middle. The busy-union arithmetic is the one the port's
smoke script uses (`device_breakdown`), copied.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import torch

LABEL = "gpubench.traced"


@dataclasses.dataclass
class Trace:
    units: int
    wall_s: float
    busy_s: float
    ops: Dict[str, Tuple[float, int]]        # name -> (seconds, count)
    gaps: Dict[str, Tuple[float, int]]       # host op -> (seconds, count)
    n_ops: int

    def matching(self, needle: str) -> Tuple[float, int]:
        """Seconds and count of the device operations whose name holds
        `needle`."""
        hits = [v for k, v in self.ops.items() if needle in k]
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    def top_ops(self, k: int = 10) -> List[list]:
        ranked = sorted(self.ops.items(), key=lambda kv: -kv[1][0])
        return [[name[:160], s] for name, (s, _) in ranked[:k]]

    def top_gaps(self, k: int = 10) -> List[list]:
        ranked = sorted(self.gaps.items(), key=lambda kv: -kv[1][0])
        return [[name[:160], s] for name, (s, _) in ranked[:k]]


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _host_at(host, starts, t, reach: int = 4096) -> str:
    """The innermost host operation running at time t: of those that
    started last before t, the first still running."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - reach), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host outside any traced op"


def profile(unit: Callable[[int], object], n: int, sync: Callable[[], None]
            ) -> Trace:
    from torch.profiler import ProfilerActivity, profile as torch_profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with torch_profile(activities=activities) as prof:
        with torch.profiler.record_function(LABEL):
            t0 = time.perf_counter()
            for i in range(n):
                unit(i)
            sync()
            wall = time.perf_counter() - t0
    events = prof.events()
    dev, host, window = [], [], None
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name == LABEL and not on_device:
            window = (start, end)
        elif on_device and (e.name == LABEL
                            or getattr(e, "is_user_annotation", False)):
            continue    # a host range mirrored on the device's timeline
        elif on_device:
            dev.append((start, end, e.name))
        else:
            host.append((start, end, e.name))
    ops: Dict[str, Tuple[float, int]] = {}
    for start, end, name in dev:
        s, c = ops.get(name, (0.0, 0))
        ops[name] = (s + (end - start) * 1e-6, c + 1)
    merged = _union([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps: Dict[str, Tuple[float, int]] = {}
    if window is not None:
        host.sort()
        starts = [h[0] for h in host]
        edges = [window[0]] + [v for m in merged for v in m] + [window[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            name = _host_at(host, starts, (a + b) / 2)
            s, c = gaps.get(name, (0.0, 0))
            gaps[name] = (s + (b - a) * 1e-6, c + 1)
    return Trace(units=n, wall_s=wall, busy_s=busy, ops=ops, gaps=gaps,
                 n_ops=len(dev))
