"""Least time of the fused x8 upsample + argmax over its kernel's traced time."""
from gpubench.readers import upsample_roofline_pct as read  # noqa: F401
