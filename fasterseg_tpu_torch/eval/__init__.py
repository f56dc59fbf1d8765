"""Whole-image evaluation: the Evaluator and the confusion-matrix metrics."""

from .evaluator import EvalResult, Evaluator, probabilities
from .metrics import (
    confusion_hist,
    hist_stats,
    compute_score,
    batch_intersection_union,
    SegMetrics,
)
