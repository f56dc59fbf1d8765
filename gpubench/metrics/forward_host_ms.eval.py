"""Host ms an image in the evaluator's forward (span eval.forward), traced sub-
window."""
from gpubench.spans import span_ms

read = span_ms("eval.forward")
