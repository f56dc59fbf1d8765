"""Derived (decoded) multi-branch segmentation network.

Counterpart of the reference's `Network_Multi_Path_Infer`
(train/model_seg.py:174-408) and of the JAX package's `DerivedNet`: a static
`NetworkPlan` drives construction. Merged-branch cells run once per group,
then BiSeNet-style aggregation (ARM 1x1 -> align-corners upsample -> concat
skip -> refine 3x3), FeatureFusion and the 1/8 head.

Submodules carry the reference's state_dict names (`stem.0.conv.0`,
`cells.{l}-{b}._op._op.conv1`, `arms32.0`, `refines16`, `ffm.conv_1x1`,
`heads8.conv_3x3`, ...), so a reference checkpoint loads with
`utils.weights.load_reference_state_dict`. The aux heads (`heads16`,
`heads32`) are built but run only in training mode, where the forward returns
(p8, p16, p32) as the JAX package's `DerivedNet(train=True)` does.

This is the plain path: every op is a torch module, and training
differentiates through it. The serving runner (models/infer.py) folds its
eval weights once and runs the hand-written kernels.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn

from ..core.plan import NetworkPlan, num_filters
from ..ops.conv import ConvNorm, upcast
from ..ops.primitives import BasicResidual2x, make_op
from ..ops.resize import resize_bilinear, scale_by
from ..ops.seg_heads import FeatureFusion, Head


class Stem(nn.ModuleList):
    """Three stride-2 stages: 1/1 -> 1/8 (model_seg.py:192-196)."""

    def __init__(self, Fch: int, stem_width: float):
        nf = lambda s: num_filters(s, Fch, stem_width)
        super().__init__([
            ConvNorm(3, nf(2) * 2, kernel_size=3, stride=2, padding=1),
            BasicResidual2x(nf(2) * 2, nf(4) * 2, stride=2),
            BasicResidual2x(nf(4) * 2, nf(8), stride=2),
        ])

    @property
    def c_out(self) -> int:
        return self[2].conv2.out_channels

    def forward(self, x):
        for stage in self:
            x = stage(x)
        return x


class _Op(nn.Module):
    """Holds a module as `_op`. A cell is _Op(_Op(primitive)), the nesting
    of the reference's Cell and MixedOp, which gives the
    `cells.{l}-{b}._op._op.*` state_dict keys."""

    def __init__(self, op: nn.Module):
        super().__init__()
        self._op = op

    def forward(self, x):
        return self._op(x)


def cell_key(layer: int, branch: int) -> str:
    return f"{layer}-{branch}"


class DerivedNet(nn.Module):
    """Plan-driven eval network. Input (1, H, W, 3) NHWC, output NHWC."""

    def __init__(self, plan: NetworkPlan):
        super().__init__()
        self.plan = plan
        hw = plan.head_width()
        nf = lambda s, w=1.0: num_filters(s, plan.Fch, w)

        self.stem = Stem(plan.Fch, plan.stem_head_width[0])
        # channel count of the latest feature per branch and per scale
        B = plan.num_branch
        c_stem = self.stem.c_out
        ch: List[int] = [c_stem] * B
        ch_at = {8: [c_stem] * B, 16: [c_stem] * B, 32: [c_stem] * B}
        self.cells = nn.ModuleDict()
        specs = {(c.layer, c.branch): c for c in plan.cells}
        for layer, groups in enumerate(plan.branch_groups):
            for group in groups:
                spec = specs[(layer, group[0])]
                stride = 2 if spec.down else 1
                self.cells[cell_key(layer, group[0])] = _Op(_Op(
                    make_op(spec.op, ch[group[0]], spec.c_out, stride)))
                for b in group:
                    ch[b] = spec.c_out
                    ch_at[spec.scale * stride][b] = spec.c_out

        pred8_ch, pred16_ch, pred32_ch = [], [], []
        for b, last in enumerate(plan.lasts):
            if last >= 1:
                pred16_ch.append(ch_at[16][b])
            if last == 2:
                pred32_ch.append(ch_at[32][b])
                self.arms32 = nn.ModuleList([
                    ConvNorm(ch_at[32][b], nf(16, hw), kernel_size=1),
                    ConvNorm(nf(16, hw), nf(8, hw), kernel_size=1)])
                self.refines32 = nn.ModuleList([
                    ConvNorm(nf(16, hw) + ch_at[16][b], nf(16, hw),
                             kernel_size=3, padding=1),
                    ConvNorm(nf(8, hw) + ch_at[8][b], nf(8, hw),
                             kernel_size=3, padding=1)])
                pred8_ch.append(nf(8, hw))
            elif last == 1:
                self.arms16 = ConvNorm(ch_at[16][b], nf(8, hw), kernel_size=1)
                self.refines16 = ConvNorm(nf(8, hw) + ch_at[8][b], nf(8, hw),
                                          kernel_size=3, padding=1)
                pred8_ch.append(nf(8, hw))
            else:
                pred8_ch.append(ch_at[8][b])

        self.ffm = FeatureFusion(sum(pred8_ch), plan.ffm_channels)
        self.heads8 = Head(plan.ffm_channels, plan.num_classes)
        # aux heads: only where their scale reaches the aggregation
        if pred16_ch:
            self.heads16 = Head(sum(pred16_ch), plan.num_classes)
        if pred32_ch:
            self.heads32 = Head(sum(pred32_ch), plan.num_classes)
        self.eval()

    def forward(self, x: torch.Tensor, upsample: bool = True):
        """Eval mode: logits (N, H, W, classes), or at 1/8 resolution with
        `upsample=False`.

        Training mode: (p8, p16, p32), the head's and the aux heads' logits
        upsampled in fp32 to the input resolution (x8, x16, x32); p16 / p32
        are None where the plan has no such head."""
        plan = self.plan
        B = plan.num_branch
        stem = self.stem(x)

        outputs = [stem] * B
        by_scale: Dict[int, List[torch.Tensor]] = {
            8: [stem] * B, 16: [stem] * B, 32: [stem] * B}
        specs = {(c.layer, c.branch): c for c in plan.cells}
        for layer, groups in enumerate(plan.branch_groups):
            for group in groups:
                spec = specs[(layer, group[0])]
                out = self.cells[cell_key(layer, group[0])](outputs[group[0]])
                out_scale = spec.scale * (2 if spec.down else 1)
                for b in group:
                    outputs[b] = out
                    by_scale[out_scale][b] = out

        # BiSeNet aggregation (model_seg.py:298-335)
        pred8, pred16, pred32 = [], [], []
        for b, last in enumerate(plan.lasts):
            o8 = by_scale[8][b]
            if last >= 1:
                pred16.append(by_scale[16][b])
            if last == 2:
                pred32.append(by_scale[32][b])
                o16 = by_scale[16][b]
                out = self.arms32[0](by_scale[32][b])
                out = resize_bilinear(out, (o16.shape[-3], o16.shape[-2]))
                out = self.refines32[0](torch.cat([out, o16], -1))
                out = self.arms32[1](out)
                out = resize_bilinear(out, (o8.shape[-3], o8.shape[-2]))
                pred8.append(self.refines32[1](torch.cat([out, o8], -1)))
            elif last == 1:
                out = self.arms16(by_scale[16][b])
                out = resize_bilinear(out, (o8.shape[-3], o8.shape[-2]))
                pred8.append(self.refines16(torch.cat([out, o8], -1)))
            else:
                pred8.append(o8)

        p8 = self.heads8(self.ffm(torch.cat(pred8, -1)))
        if self.training:
            p16 = p32 = None
            if pred32:
                p32 = scale_by(upcast(self.heads32(torch.cat(pred32, -1))), 32)
            if pred16:
                p16 = scale_by(upcast(self.heads16(torch.cat(pred16, -1))), 16)
            return scale_by(upcast(p8), 8), p16, p32
        return scale_by(p8, 8) if upsample else p8
