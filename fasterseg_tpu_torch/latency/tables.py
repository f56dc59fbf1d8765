"""Supernet latency tensors from a latency LUT.

Copy of the JAX package's latency/tables.py (numpy). The reference prices
the supernet by dict lookups keyed by the sampled widths inside its forward
(model_search.py:361-476); here every lookup is made once into constant
tensors:

    keep[i, j, op, wi, wo]  latency of `op` at layer i, scale j with input
                            width wi and output width wo
    down[i, j, op, wi, wo]  the same for the stride-2 branch

so the differentiable estimator (latency/estimator.py) is a gather and a
contraction on the device. Scale j lives at (H, W) / (8 * 2^j) of the
latency input (architect.py:66 uses 1024x2048). `make_divisible` comes from
the port's own ops/slimmable.py.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..core.plan import num_filters
from ..ops.slimmable import make_divisible
from .lut import LatencyLUT, convnorm_key, op_key

NUM_OPS = 5


def scales_at(layer: int) -> int:
    return min(layer + 1, 3)


def has_down(layer: int, scale: int, layers: int) -> bool:
    return scale < 2 and layer < layers - 1


def build_supernet_tables(lut: LatencyLUT, layers: int, Fch: int,
                          width_mult_list: Sequence[float],
                          input_hw: Tuple[int, int] = (1024, 2048)):
    """Returns dict(keep=(L,3,5,nw,nw), down=(L,3,5,nw,nw), stem=(n_arch,))
    as numpy float32; nonexistent cells stay zero."""
    H, W = input_hw
    nw = len(width_mult_list)
    keep = np.zeros((layers, 3, NUM_OPS, nw, nw), np.float32)
    down = np.zeros((layers, 3, NUM_OPS, nw, nw), np.float32)

    for i in range(layers):
        for j in range(scales_at(i)):
            c_max = num_filters(8 * 2 ** j, Fch)
            h = H // (8 * 2 ** j)
            w = W // (8 * 2 ** j)
            for wi_idx, wi in enumerate(width_mult_list):
                c_in = make_divisible(c_max * wi)
                for wo_idx, wo in enumerate(width_mult_list):
                    c_out = make_divisible(c_max * wo)
                    c_down = make_divisible(2 * c_max * wo)
                    for op in range(NUM_OPS):
                        keep[i, j, op, wi_idx, wo_idx] = lut.get_op(
                            op, h, w, c_in, c_out, 1)
                        if has_down(i, j, layers):
                            down[i, j, op, wi_idx, wo_idx] = lut.get_op(
                                op, h, w, c_in, c_down, 2)
    return {"keep": keep, "down": down}


def stem_latency_ms(lut: LatencyLUT, Fch: int, stem_width: float,
                    input_hw: Tuple[int, int] = (1024, 2048)) -> float:
    """Stem: ConvNorm s2 + two BasicResidual2x s2 (model_search.py:146-151)."""
    H, W = input_hw
    nf = lambda s: num_filters(s, Fch, stem_width)
    total = lut.get(convnorm_key(H, W, 3, nf(2) * 2, 3, 2))
    total += lut.get_op(3, H // 2, W // 2, nf(2) * 2, nf(4) * 2, 2)
    total += lut.get_op(3, H // 4, W // 4, nf(4) * 2, nf(8), 2)
    return float(total)
