"""Set-up seconds: process start to the window's start (loading, building, warming up, capturing)."""
from gpubench.readers import setup_s as read  # noqa: F401
