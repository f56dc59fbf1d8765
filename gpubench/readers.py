"""How each metric is read from a run's `harness.Outcome`.

A metric's own file, `metrics/<name>.py`, binds one of these as `read`. A
reader returns None where the run holds nothing for it (no trace, or a
trace whose kernels do not match the plan), and the metric is then left out
of the result. End-to-end metrics read the host clock of the measured
window; per-layer ones the traced sub-window that follows it, or the
window's own spans.
"""

from __future__ import annotations

import statistics

import numpy as np

from .flops import PEAK_FLOPS


def setup_s(out):
    return out.setup_s


def rate(out):
    """Images (frames) in completed units over the window's seconds."""
    return out.items / out.window_s


def p95_ms(out):
    """95th percentile of every unit's latency in the window."""
    return float(np.percentile(out.unit_s, 95)) * 1e3


def p50_ms(out):
    return statistics.median(out.unit_s) * 1e3


def _device_trace(out):
    """The traced sub-window, where it saw the device work."""
    if out.trace is None or out.device_type != "cuda" or not out.trace.n_ops:
        return None
    return out.trace


def launches_per_unit(out):
    """Device operations (kernels, copies, memsets) a unit."""
    if _device_trace(out) is None:
        return None
    return out.trace.n_ops / out.trace.units


def span_mean_ms(name):
    def read(out):
        s = out.spans.get(name)
        return statistics.fmean(s) * 1e3 if s else None
    return read


def device_ms(out):
    """The device's busy time (union of its operations) a unit."""
    if _device_trace(out) is None:
        return None
    return out.trace.busy_s / out.trace.units * 1e3


def idle_pct(out):
    if _device_trace(out) is None:
        return None
    return 100.0 * (1.0 - out.trace.busy_s / out.trace.wall_s)


def mfu_pct(out):
    """The units' FLOPs over the window's seconds, as a share of the dense
    bf16 tensor-core peak."""
    if not out.flops_per_unit or out.device_type != "cuda":
        return None
    return 100.0 * out.flops_per_unit * out.units / out.window_s / PEAK_FLOPS


def _roofline(out, needle, bound_s, per_unit):
    if _device_trace(out) is None or bound_s is None:
        return None
    seconds, count = out.trace.matching(needle)
    if count != per_unit * out.trace.units or seconds <= 0:
        return None
    return 100.0 * bound_s * out.trace.units / seconds


def conv_roofline_pct(out):
    """The least time of the plan's 3x3 convs over the time of the port's
    conv kernels, where they launch once a conv."""
    return _roofline(out, "conv3x3", out.conv_bound_s, out.convs3x3)


def upsample_roofline_pct(out):
    return _roofline(out, "upsample_argmax", out.upsample_bound_s,
                     out.upsamples)
