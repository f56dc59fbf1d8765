"""Class-map frames completed over the window's seconds, graph-served stream."""
from gpubench.readers import rate as read  # noqa: F401
