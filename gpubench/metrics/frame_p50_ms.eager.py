"""Median frame latency over the window of the traced run (the untraced part)."""
from gpubench.readers import p50_ms as read  # noqa: F401
