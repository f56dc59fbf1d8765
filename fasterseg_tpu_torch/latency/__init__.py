"""Latency: the LUT and its reference table, the supernet's latency tables
and differentiable estimator, and the decoded network's estimate."""

from .lut import (
    LatencyLUT,
    REFERENCE_LUT,
    op_key,
    convnorm_key,
    ffm_key,
    head_key,
    parse_key,
    reference_lut,
)
from .tables import build_supernet_tables, stem_latency_ms
from .estimator import expected_latency_ms, cell_ratio_wiring
from .derived import derived_latency_ms, fps_of
