"""Forward FLOPs of the window's images over its seconds, share of 989 TFLOP/s."""
from gpubench.readers import mfu_pct as read  # noqa: F401
