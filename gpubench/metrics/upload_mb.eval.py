"""MB an image uploaded by the evaluator (counter eval.upload_bytes / 1e6),
traced sub-window."""
from gpubench.spans import counter_per_unit

read = counter_per_unit("eval.upload_bytes", 1e-6)
