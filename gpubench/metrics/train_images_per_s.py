"""Images in completed training steps over the window's seconds, loader waits included."""
from gpubench.readers import rate as read  # noqa: F401
