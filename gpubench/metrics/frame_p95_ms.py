"""95th percentile of every frame's latency in the window, eager stream."""
from gpubench.readers import p95_ms as read  # noqa: F401
