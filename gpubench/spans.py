"""The port's own spans and counters (`fasterseg_tpu_torch.utils.profiling`),
as the per-layer metrics of its stages read them.

The port records its spans and counters while a torch.profiler profile is
active on the calling thread: in a run, the traced sub-window
(`trace.profile`). A metric is the sub-window's total of one or more spans
(host ms) or of a counter, divided by the sub-window's units. It reads None
off the card (on the CPU the port runs the plain versions of its kernels,
so a span's host time is another program's), without a trace, and where
the program records no such span or counter (a port from before them:
the benchmark runs its files over earlier checkouts of the port too).
"""

from __future__ import annotations


def _traced(out):
    if out.device_type != "cuda" or out.trace is None or not out.trace.units:
        return None
    from fasterseg_tpu_torch.utils import profiling
    # a port from before its spans has no summary: its metrics read None
    read = getattr(profiling, "summary", None)
    return read() if read is not None else None


def span_ms(*names, field="total_ms"):
    """Host ms a unit in the spans `names`, summed, in the traced
    sub-window; `field="self_ms"` leaves out what their child spans
    cover."""
    def read(out):
        s = _traced(out)
        if s is None or not all(n in s["spans"] for n in names):
            return None
        return sum(s["spans"][n][field] for n in names) / out.trace.units
    return read


def counter_per_unit(name, scale=1.0):
    """Counter `name` times `scale`, a unit of the traced sub-window."""
    def read(out):
        s = _traced(out)
        if s is None or name not in s["counters"]:
            return None
        return s["counters"][name] * scale / out.trace.units
    return read
