"""Host ms a step in the training forward (span train.forward), traced sub-
window."""
from gpubench.spans import span_ms

read = span_ms("train.forward")
