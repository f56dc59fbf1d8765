"""Supernet pretrain and bi-level architecture search: Gumbel width
sampling, the architect, the search engine and its driver."""

from .gumbel import draw_noise, gumbel_softmax, sample_gumbel, sample_ratios
from .architect import (
    LatencyWeightController,
    latency_terms,
    make_arch_optimizer,
)
from .loop import (SearchEngine, clip_by_global_norm_, forward_plan, run_search,
                   to_device)
