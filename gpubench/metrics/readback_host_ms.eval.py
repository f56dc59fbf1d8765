"""Host ms an image in the pass's readback of the counts and score (span
eval.readback), traced sub-window."""
from gpubench.spans import span_ms

read = span_ms("eval.readback")
