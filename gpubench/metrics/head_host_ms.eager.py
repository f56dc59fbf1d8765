"""Host ms a frame in the head and the class map's upsample (spans infer.head +
infer.upsample), traced sub-window."""
from gpubench.spans import span_ms

read = span_ms("infer.head", "infer.upsample")
