"""Device operations a frame, from the traced sub-window."""
from gpubench.readers import launches_per_unit as read  # noqa: F401
