"""1 - device busy / host wall over the traced sub-window."""
from gpubench.readers import idle_pct as read  # noqa: F401
