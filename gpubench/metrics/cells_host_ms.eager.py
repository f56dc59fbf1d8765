"""Host ms a frame in the runner's cell loop (span infer.cells), traced sub-
window."""
from gpubench.spans import span_ms

read = span_ms("infer.cells")
