"""Images through Evaluator.run over the window's seconds, hist on the host at each pass's end."""
from gpubench.readers import rate as read  # noqa: F401
