"""Operations, bytes and bounds of the network, from its plan alone.

`plan_flops` is a frozen copy of the port's static FLOP count (thop's
convention: a conv's multiply-adds are k*k*C_in per output element, FLOPs
twice that; convs only). `convs3x3` lists the forward's 3x3 convs, the ones
the port's conv kernel runs, and `conv_bound_s` is the least time the card
could take for them: per conv the larger of its operations over the peak
rate and its bytes (each input, weight and output element once) over the
peak bandwidth. Peaks are NVIDIA's data sheet for the H100 SXM, dense.
"""

from __future__ import annotations

from typing import List, Tuple

from .reference.plan import Plan, num_filters, stem_channels

PEAK_FLOPS = 989e12          # bf16 / fp16 tensor cores, dense
PEAK_FP32_CUDA_CORE = 67e12  # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # HBM3


def conv_flops(h: int, w: int, c_in: int, c_out: int, k: int = 3,
               stride: int = 1) -> int:
    return 2 * (h // stride) * (w // stride) * k * k * c_in * c_out


def _op_convs(op: int, h: int, w: int, c_in: int, c_out: int, stride: int
              ) -> List[Tuple[int, int, int, int, int, int]]:
    """(h, w, c_in, c_out, k, stride) of each conv of a primitive."""
    if op == 0:
        if stride == 1:
            return []
        return [(h, w, c_in, c_out // 2, 1, 2)] * 2
    if op == 1:
        return [(h, w, c_in, c_out, 3, stride)]
    if op == 2:
        return [(h // 2, w // 2, c_in, c_out, 3, 1)]
    if op == 3:
        return [(h, w, c_in, c_out, 3, stride),
                (h // stride, w // stride, c_out, c_out, 3, 1)]
    if op == 4:
        return [(h // 2, w // 2, c_in, c_out, 3, 1),
                (h // 2, w // 2, c_out, c_out, 3, 1)]
    raise ValueError(op)


def convs(plan: Plan, hw: Tuple[int, int]) -> List[Tuple[int, ...]]:
    """Every conv of one eval forward at input `hw`, as (h, w, c_in, c_out,
    k, stride) with (h, w) its input map."""
    H, W = hw
    s1, s2, s3 = stem_channels(plan)
    out = [(H, W, 3, s1, 3, 2)]
    out += _op_convs(3, H // 2, W // 2, s1, s2, 2)
    out += _op_convs(3, H // 4, W // 4, s2, s3, 2)
    for c in plan.cells:
        out += _op_convs(c.op, H // c.scale, W // c.scale, c.c_in, c.c_out,
                         2 if c.down else 1)
    nf = lambda s: num_filters(s, plan.fch, plan.head_width)
    h8, w8, h16, w16, h32, w32 = H // 8, W // 8, H // 16, W // 16, H // 32, W // 32
    if 2 in plan.lasts:
        out += [(h32, w32, nf(32), nf(16), 1, 1),
                (h16, w16, nf(16) + plan.ch_16, nf(16), 3, 1),
                (h16, w16, nf(16), nf(8), 1, 1),
                (h8, w8, nf(8) + plan.ch_8_2, nf(8), 3, 1)]
    if 1 in plan.lasts:
        out += [(h16, w16, nf(16), nf(8), 1, 1),
                (h8, w8, nf(8) + plan.ch_8_1, nf(8), 3, 1)]
    ffm = plan.ffm_channels
    mid = ffm if ffm <= 256 else ffm // 2
    out += [(h8, w8, ffm, ffm, 1, 1), (h8, w8, ffm, mid, 3, 1),
            (h8, w8, mid, plan.num_classes, 1, 1)]
    return out


def plan_flops(plan: Plan, hw: Tuple[int, int] = (1024, 2048)) -> int:
    """FLOPs of one eval forward (convs only)."""
    return sum(conv_flops(h, w, ci, co, k, s) for h, w, ci, co, k, s
               in convs(plan, hw))


def convs3x3(plan: Plan, hw: Tuple[int, int]) -> List[Tuple[int, ...]]:
    return [c for c in convs(plan, hw) if c[4] == 3]


def conv_bound_s(h: int, w: int, c_in: int, c_out: int, k: int, stride: int,
                 elem_bytes: int) -> float:
    ops = conv_flops(h, w, c_in, c_out, k, stride)
    nbytes = elem_bytes * (h * w * c_in + k * k * c_in * c_out
                           + (h // stride) * (w // stride) * c_out)
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def convs3x3_bound_s(plan: Plan, hw: Tuple[int, int], elem_bytes: int
                     ) -> float:
    """The least time of one forward's 3x3 convs."""
    return sum(conv_bound_s(*c, elem_bytes) for c in convs3x3(plan, hw))


def upsample_bound_s(h8: int, w8: int, classes: int, H: int, W: int,
                     elem_bytes: int) -> float:
    """The least time of the fused x8 upsample + argmax: the 1/8 logits
    read once and the int32 class map written once, against its least
    operations on the CUDA cores (separable bilinear, the H pass shared by
    the output columns: 3 per element of each pass, one compare per
    output element and class)."""
    nbytes = h8 * w8 * classes * elem_bytes + H * W * 4
    ops = 3 * H * w8 * classes + 3 * H * W * classes + H * W * classes
    return max(nbytes / PEAK_BYTES, ops / PEAK_FP32_CUDA_CORE)
