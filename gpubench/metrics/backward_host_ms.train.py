"""Host ms a step in loss.backward() (span train.backward), traced sub-
window."""
from gpubench.spans import span_ms

read = span_ms("train.backward")
