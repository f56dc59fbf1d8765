"""Host ms a step spent in next() on the loader, mean over the window."""
from gpubench.readers import span_mean_ms

read = span_mean_ms("loader_wait")
