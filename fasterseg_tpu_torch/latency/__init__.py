"""Latency: the LUT with the reference's table and the H100's, the
supernet's latency tables and differentiable estimator, the decoded
network's estimate and FPS band, and the H100 cost model. The measuring
harness and provider are in latency/measure.py (imported on use)."""

from .lut import (
    H100_LUT,
    LatencyLUT,
    REFERENCE_LUT,
    op_key,
    convnorm_key,
    ffm_key,
    head_key,
    parse_key,
    h100_lut,
    reference_lut,
)
from .tables import build_supernet_tables, stem_latency_ms
from .estimator import expected_latency_ms, cell_ratio_wiring
from .derived import REF_BAND_REL, derived_latency_ms, fps_band, fps_of
from .cost_model import H100CostModel
