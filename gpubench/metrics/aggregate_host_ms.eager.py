"""Host ms a frame in the BiSeNet aggregation: arms, refines, their resizes
(span infer.aggregate), traced sub-window."""
from gpubench.spans import span_ms

read = span_ms("infer.aggregate")
