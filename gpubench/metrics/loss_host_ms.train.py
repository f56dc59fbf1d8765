"""Host ms a step in the OHEM losses (span train.loss), traced sub-window."""
from gpubench.spans import span_ms

read = span_ms("train.loss")
