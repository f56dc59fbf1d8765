"""Host ms an image in the evaluator's upload less its copies to the card:
stacking, label cast, normalisation (span eval.upload's self time; its child
eval.copy, which also waits for the card's queued work, left out), traced
sub-window."""
from gpubench.spans import span_ms

read = span_ms("eval.upload", field="self_ms")
