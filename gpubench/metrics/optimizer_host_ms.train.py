"""Host ms a step in zero_grad and the update (span train.optimizer), traced
sub-window."""
from gpubench.spans import span_ms

read = span_ms("train.optimizer")
