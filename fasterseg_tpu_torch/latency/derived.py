"""End-to-end latency estimate of a decoded (derived) network.

Copy of the JAX package's latency/derived.py (host-side Python over a static
NetworkPlan), the counterpart of Network_Multi_Path_Infer.forward_latency
(train/model_seg.py:360-408): walk the plan's merged cells and the BiSeNet
aggregation, summing LUT entries. Search reads it for the decoded
architectures' FPS (train_search.py:274-303).

Reference quirks fixed, as in the JAX package:
* `outputs4` NameError dead branch (model_seg.py:388): scales come from the
  plan's static geometry instead.
* FeatureFusion/Head `_latency` priced hardcoded scale*Fch*branch channels
  instead of the actual tensor channels (seg_oprs.py:207-217,258-269): the
  actual channels are used.
"""

from __future__ import annotations

from typing import Tuple

from ..core.plan import NetworkPlan, num_filters
from .lut import LatencyLUT, convnorm_key, ffm_key, head_key, op_key


def stem_latency(lut: LatencyLUT, plan: NetworkPlan,
                 input_hw: Tuple[int, int]) -> float:
    H, W = input_hw
    nf = lambda s: num_filters(s, plan.Fch, plan.stem_head_width[0])
    total = lut.get(convnorm_key(H, W, 3, nf(2) * 2, 3, 2))
    total += lut.get_op(3, H // 2, W // 2, nf(2) * 2, nf(4) * 2, 2)
    total += lut.get_op(3, H // 4, W // 4, nf(4) * 2, nf(8), 2)
    return float(total)


def derived_latency_ms(lut: LatencyLUT, plan: NetworkPlan,
                       input_hw: Tuple[int, int] = (1024, 2048),
                       calibrate: bool = True) -> float:
    """Total estimated ms for one eval-mode forward at input_hw. With
    calibrate=True the per-op sum is multiplied by the LUT's correction
    factor for the plan's width family (`LatencyLUT.factor_for`); the
    reference's table carries none (1.0)."""
    H, W = input_hw
    total = stem_latency(lut, plan, input_hw)
    hw = plan.head_width()
    nf = lambda s, w=1.0: num_filters(s, plan.Fch, w)

    specs = {(c.layer, c.branch): c for c in plan.cells}
    for layer, groups in enumerate(plan.branch_groups):
        for group in groups:
            c = specs[(layer, group[0])]
            h, w = H // c.scale, W // c.scale
            total += lut.get_op(c.op, h, w, c.c_in, c.c_out,
                                2 if c.down else 1)

    # aggregation (model_seg.py:392-407)
    h8, w8 = H // 8, W // 8
    h16, w16 = H // 16, W // 16
    h32, w32 = H // 32, W // 32
    if 2 in plan.lasts:
        total += lut.get(convnorm_key(h32, w32, nf(32, hw), nf(16, hw), 1, 1))
        total += lut.get(convnorm_key(
            h16, w16, nf(16, hw) + plan.ch_16, nf(16, hw), 3, 1))
        total += lut.get(convnorm_key(h16, w16, nf(16, hw), nf(8, hw), 1, 1))
        total += lut.get(convnorm_key(
            h8, w8, nf(8, hw) + plan.ch_8_2, nf(8, hw), 3, 1))
    if 1 in plan.lasts:
        total += lut.get(convnorm_key(h16, w16, nf(16, hw), nf(8, hw), 1, 1))
        total += lut.get(convnorm_key(
            h8, w8, nf(8, hw) + plan.ch_8_1, nf(8, hw), 3, 1))
    total += lut.get(ffm_key(h8, w8, plan.ffm_channels))
    total += lut.get(head_key(h8, w8, plan.heads8_in, plan.num_classes))
    if calibrate:
        total *= lut.factor_for(plan.stem_head_width[0])
    return float(total)


def fps_of(lut: LatencyLUT, plan: NetworkPlan,
           input_hw: Tuple[int, int] = (1024, 2048)) -> float:
    return 1000.0 / derived_latency_ms(lut, plan, input_hw)


# The reference holds its student in [155, 175] FPS around its shipped
# genotype's 159.7 LUT-FPS operating point (config_search.py:85-86 vs
# arch_0.pt latency02 = 6.26 ms): a band RELATIVE to the estimate, about
# [-3 %, +10 %].
# Scaling it by the same table's estimate of the operating point keeps the
# controller's pressure there independent of the table's absolute scale.
REF_BAND_REL = (155.0 / 159.7, 175.0 / 159.7)


def fps_band(lut: LatencyLUT, plan: NetworkPlan,
             input_hw: Tuple[int, int] = (1024, 2048)) -> Tuple[float, float]:
    """The student's FPS band on `lut`'s (calibrated) scale: REF_BAND_REL
    times `lut`'s FPS estimate of `plan`, normally the shipped student.
    Counterpart of the JAX package's `tpu_fps_band` (latency/derived.py)."""
    fps = fps_of(lut, plan, input_hw)
    return (REF_BAND_REL[0] * fps, REF_BAND_REL[1] * fps)
