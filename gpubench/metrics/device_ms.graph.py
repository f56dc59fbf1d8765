"""Device busy ms a frame (union of its operations), traced sub-window."""
from gpubench.readers import device_ms as read  # noqa: F401
