"""Static FLOPs and parameter counts.

Copy of the JAX package's utils/flops.py, the counterpart of the reference's
thop.profile at model build (train_search.py:67-68, train/train.py:116-117)
and its per-op `_flops` helpers (operations.py:91-95 et al.): computed from
the static NetworkPlan, with no forward run. `param_count` counts an
`nn.Module`'s parameters.

thop's convention for convs: MACs per output element = k*k*C_in (grouped
convs divide), FLOPs = 2 * MACs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.plan import NetworkPlan, num_filters


def param_count(module: torch.nn.Module) -> int:
    """Parameters of `module` (BN running statistics are buffers, not
    parameters, as they are batch_stats in the JAX package)."""
    return int(sum(p.numel() for p in module.parameters()))


def conv_flops(h: int, w: int, c_in: int, c_out: int, k: int = 3,
               stride: int = 1, groups: int = 1) -> int:
    ho, wo = h // stride, w // stride
    return 2 * ho * wo * k * k * (c_in // groups) * c_out


def op_flops(op_idx: int, h: int, w: int, c_in: int, c_out: int,
             stride: int) -> int:
    """Per-primitive FLOPs (structure per ops/primitives.py)."""
    if op_idx == 0:
        if stride == 1:
            return 0 if c_in == c_out else conv_flops(h, w, c_in, c_out, 1)
        return 2 * conv_flops(h, w, c_in, c_out // 2, 1, 2)
    if op_idx == 1:
        return conv_flops(h, w, c_in, c_out, 3, stride)
    if op_idx == 2:
        return conv_flops(h // 2, w // 2, c_in, c_out, 3, 1)
    if op_idx == 3:
        return (conv_flops(h, w, c_in, c_out, 3, stride)
                + conv_flops(h // stride, w // stride, c_out, c_out, 3, 1))
    if op_idx == 4:
        return (conv_flops(h // 2, w // 2, c_in, c_out, 3, 1)
                + conv_flops(h // 2, w // 2, c_out, c_out, 3, 1))
    raise ValueError(op_idx)


def plan_flops(plan: NetworkPlan,
               input_hw: Tuple[int, int] = (1024, 2048)) -> int:
    """Total eval-forward FLOPs of a derived network."""
    H, W = input_hw
    hw_ratio = plan.head_width()
    nf = lambda s, w=1.0: num_filters(s, plan.Fch, w)
    sw = plan.stem_head_width[0]

    total = conv_flops(H, W, 3, nf(2, sw) * 2, 3, 2)
    total += op_flops(3, H // 2, W // 2, nf(2, sw) * 2, nf(4, sw) * 2, 2)
    total += op_flops(3, H // 4, W // 4, nf(4, sw) * 2, nf(8, sw), 2)

    specs = {(c.layer, c.branch): c for c in plan.cells}
    for layer, groups in enumerate(plan.branch_groups):
        for group in groups:
            c = specs[(layer, group[0])]
            total += op_flops(c.op, H // c.scale, W // c.scale,
                              c.c_in, c.c_out, 2 if c.down else 1)

    h8, w8, h16, w16, h32, w32 = (H // 8, W // 8, H // 16, W // 16,
                                  H // 32, W // 32)
    if 2 in plan.lasts:
        total += conv_flops(h32, w32, nf(32, hw_ratio), nf(16, hw_ratio), 1)
        total += conv_flops(h16, w16, nf(16, hw_ratio) + plan.ch_16,
                            nf(16, hw_ratio), 3)
        total += conv_flops(h16, w16, nf(16, hw_ratio), nf(8, hw_ratio), 1)
        total += conv_flops(h8, w8, nf(8, hw_ratio) + plan.ch_8_2,
                            nf(8, hw_ratio), 3)
    if 1 in plan.lasts:
        total += conv_flops(h16, w16, nf(16, hw_ratio), nf(8, hw_ratio), 1)
        total += conv_flops(h8, w8, nf(8, hw_ratio) + plan.ch_8_1,
                            nf(8, hw_ratio), 3)
    total += conv_flops(h8, w8, plan.ffm_channels, plan.ffm_channels, 1)
    mid = plan.heads8_in if plan.heads8_in <= 256 else plan.heads8_in // 2
    total += conv_flops(h8, w8, plan.heads8_in, mid, 3)
    total += conv_flops(h8, w8, mid, plan.num_classes, 1)
    return int(total)
