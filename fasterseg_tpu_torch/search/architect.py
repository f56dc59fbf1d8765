"""Architect: the architecture-parameter optimizer and the latency penalty.

Counterpart of the JAX package's search/architect.py (the reference's
search/architect.py): first-order DARTS with one Adam (lr 3e-4, betas
(0.5, 0.999), eps 1e-8 as optax's, no weight decay; architect.py:22-24) over
every alpha, beta and ratio tensor, minimising the validation-batch
supernet loss plus a fine-grained latency penalty (architect.py:55-76):

  loss_latency = sum_idx w_idx * [ r0 * E_lat(alpha | beta uniform, width max)
                                 + r1 * E_lat(beta | alpha uniform, width max)
                                 + r2 * E_lat(width | alpha, beta uniform) ]
  (r0, r1, r2) = (1, 497, 2) / 500   (1/500 and 499/500 with one width)

The FPS-band controller (train_search.py:204-212) doubles or halves w_idx
after each epoch, capped at initial * 2^8. The reference's unrolled
second-order path (architect.py:78-127) is dead code there
(config_search.py:107 unrolled=False) and is not ported.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch

from ..latency.estimator import expected_latency_ms
from .gumbel import sample_ratios


def make_arch_optimizer(params: Iterable[torch.Tensor], lr: float = 3e-4
                        ) -> torch.optim.Adam:
    """optax.adam(lr, b1=0.5, b2=0.999) (eps 1e-8, no weight decay)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.999), eps=1e-8,
                            weight_decay=0.0)


def latency_terms(tables, stem_ms_per_arch: Sequence[float], arch_params,
                  layers: int, num_widths: int, prun_modes, stem_pins,
                  head_pins, noise: Optional[Dict[int, list]] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[int, torch.Tensor]:
    """Per-arch expected latency with the reference's alpha/beta/ratio
    split (architect.py:62-74): {arch_idx: ms}. `noise[idx]` holds the
    draws of arch idx's width sample in its prun mode (`draw_noise`)."""
    out: Dict[int, torch.Tensor] = {}
    if num_widths == 1:
        r0, r1, r2 = 1.0 / 500, 499.0 / 500, 0.0
    else:
        r0, r1, r2 = 1.0 / 500, 497.0 / 500, 2.0 / 500
    for idx, ap in arch_params.items():
        max_ratios = sample_ratios(ap.ratios, "max", num_widths)
        args = dict(tables=tables, stem_ms=stem_ms_per_arch[idx],
                    layers=layers, stem_pin=stem_pins[idx],
                    head_pin=head_pins[idx])
        lat = r0 * expected_latency_ms(
            alphas=ap.alphas, betas=ap.betas, ratios=max_ratios,
            use_alpha=True, use_beta=False, **args)
        lat = lat + r1 * expected_latency_ms(
            alphas=ap.alphas, betas=ap.betas, ratios=max_ratios,
            use_alpha=False, use_beta=True, **args)
        if r2 > 0:
            g_ratios = sample_ratios(
                ap.ratios, prun_modes[idx], num_widths, generator,
                None if noise is None else noise[idx])
            lat = lat + r2 * expected_latency_ms(
                alphas=ap.alphas, betas=ap.betas, ratios=g_ratios,
                use_alpha=False, use_beta=False, **args)
        out[idx] = lat
    return out


class LatencyWeightController:
    """FPS-band feedback on the latency penalty (train_search.py:204-212):
    halve when either decoded branch is at or above FPS_max, double when
    either is at or below FPS_min.

    As in the JAX package (PARITY.md), the doubling is capped at
    `initial_weight * 2**max_doublings` (default 256x): the reference's rule
    is unbounded, and a decoded architecture that starts below the band
    then doubles the weight every epoch until the latency term swamps the
    task loss."""

    def __init__(self, latency_weight: Sequence[float],
                 fps_min: Sequence[float], fps_max: Sequence[float],
                 max_doublings: int = 8):
        self.weights = list(latency_weight)
        self.fps_min = list(fps_min)
        self.fps_max = list(fps_max)
        self.max_weights = [w * 2.0 ** max_doublings for w in self.weights]

    def update(self, arch_idx: int, fps0: float, fps1: float) -> float:
        if self.weights[arch_idx] > 0:
            if fps0 >= self.fps_max[arch_idx] or fps1 >= self.fps_max[arch_idx]:
                self.weights[arch_idx] /= 2
            elif fps0 <= self.fps_min[arch_idx] or fps1 <= self.fps_min[arch_idx]:
                self.weights[arch_idx] = min(self.weights[arch_idx] * 2,
                                             self.max_weights[arch_idx])
        return self.weights[arch_idx]
