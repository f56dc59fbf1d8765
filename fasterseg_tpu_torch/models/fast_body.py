"""Serving path after the stem: the decoded cell body, BiSeNet aggregation,
FFM and head, on NHWC tensors through the hand-written kernels.

Counterpart of the JAX package's models/fast_body.py (`fast_body`,
fast_body.py:217-287), cell for cell:

* every 3x3 conv + folded BN (+ReLU) runs `kernels.conv3x3_bn_relu` (cells,
  refine convs over concats, the head 3x3), at stride 1 or 2;
* 1x1 convs (ARM, FFM, classifier) and FactorizedReduce's two offset
  stride-2 1x1 convs are fp32 matrix products over channels with a fused
  fp32 epilogue, as the JAX package leaves them to XLA einsums;
* zoomed-cell and aggregation resizes are the constant-matrix contractions
  of ops/resize.py;
* a refine conv over a channel concat concatenates its NHWC inputs first.

The weights are folded once by `fold_weights`, not per call.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..core.plan import NetworkPlan
from ..kernels.conv import conv3x3_bn_relu
from ..ops.conv import BatchNorm, Conv
from ..ops.primitives import FactorizedReduce
from ..ops.resize import downsample_half, resize_bilinear
from .derived import DerivedNet, cell_key

# Weights stay fp32 whatever the activation dtype: they are a few hundred
# KB, and the conv kernel keeps fp32-weight accuracy (its tensor-core path
# splits each weight into bf16 hi + lo); rounding them to bf16 (as the JAX
# package does for the MXU) would add error for nothing.
# (w (3,3,Ci,Co) HWIO fp32, scale (Co,) fp32, bias (Co,) fp32)
Folded3x3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# (w (Ci,Co) fp32, scale (Co,) or None, bias (Co,))
Folded1x1 = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]


def fold3x3(conv: Conv, bn: BatchNorm) -> Folded3x3:
    w = conv.weight.detach().permute(2, 3, 1, 0).float().contiguous()
    scale, bias = bn.folded()
    return w, scale.detach().contiguous(), bias.detach().contiguous()


def _w1x1(conv: Conv) -> torch.Tensor:
    return conv.weight.detach()[:, :, 0, 0].t().float().contiguous()


def fold1x1(conv: Conv, bn: Optional[BatchNorm]) -> Folded1x1:
    if bn is None:
        return _w1x1(conv), None, conv.bias.detach().float()
    scale, bias = bn.folded()
    return _w1x1(conv), scale.detach(), bias.detach()


def _fold_cell(op: torch.nn.Module) -> Dict:
    if isinstance(op, FactorizedReduce):
        if op.stride == 1:                           # identity skip
            return {}
        scale, bias = op.bn.folded()
        return {"fr": (_w1x1(op.conv1), _w1x1(op.conv2), scale.detach(),
                       bias.detach())}
    p = {"c0": fold3x3(op.conv1, op.bn1)}
    if hasattr(op, "conv2"):
        p["c1"] = fold3x3(op.conv2, op.bn2)
    return p


@torch.no_grad()
def fold_weights(net: DerivedNet) -> Dict:
    """Folded BN and fp32 weights of `net` for fast_stem / fast_body."""
    stem = [fold3x3(net.stem[0].conv[0], net.stem[0].conv[1])]
    for stage in list(net.stem)[1:]:
        stem += [fold3x3(stage.conv1, stage.bn1),
                 fold3x3(stage.conv2, stage.bn2)]
    fw = {"stem": stem,
          "cells": {k: _fold_cell(c._op._op) for k, c in net.cells.items()},
          "ffm": fold1x1(net.ffm.conv_1x1.conv, net.ffm.conv_1x1.bn),
          "head3": fold3x3(net.heads8.conv_3x3.conv, net.heads8.conv_3x3.bn),
          "cls": fold1x1(net.heads8.conv_1x1, None)}
    if hasattr(net, "arms32"):
        fw["arms32"] = [fold1x1(m.conv[0], m.conv[1]) for m in net.arms32]
        fw["refines32"] = [fold3x3(m.conv[0], m.conv[1])
                           for m in net.refines32]
    if hasattr(net, "arms16"):
        fw["arms16"] = fold1x1(net.arms16.conv[0], net.arms16.conv[1])
        fw["refines16"] = fold3x3(net.refines16.conv[0], net.refines16.conv[1])
    return fw


def _epilogue(y: torch.Tensor, scale, bias, relu: bool, dtype) -> torch.Tensor:
    if scale is not None:
        y = y * scale
    y = y + bias
    if relu:
        y = torch.relu(y)
    return y.to(dtype)


def _conv1x1(x: torch.Tensor, p: Folded1x1, relu: bool = True) -> torch.Tensor:
    """1x1 conv + folded BN (+ReLU): an fp32 product over channels."""
    w, scale, bias = p
    return _epilogue(torch.matmul(x.float(), w), scale, bias, relu, x.dtype)


def _factorized_reduce(x: torch.Tensor, p) -> torch.Tensor:
    """'skip' at stride 2 (operations.py:521-526): 1x1 convs at pixel
    offsets (0,0) and (1,1), stride 2, channel concat, BN, ReLU."""
    wa, wb, scale, bias = p["fr"]
    y = torch.cat([torch.matmul(x[:, 0::2, 0::2].float(), wa),
                   torch.matmul(x[:, 1::2, 1::2].float(), wb)], dim=-1)
    return _epilogue(y, scale, bias, True, x.dtype)


def _run_cell(op: int, x: torch.Tensor, p: Dict, stride: int) -> torch.Tensor:
    """One decoded cell (ops/primitives.py classes) on an NHWC input."""
    if op == 0:
        return x if stride == 1 else _factorized_reduce(x, p)
    h, w = x.shape[1], x.shape[2]
    if op == 1:    # conv
        return conv3x3_bn_relu(x, *p["c0"], stride=stride)
    if op == 3:    # conv_2x
        y = conv3x3_bn_relu(x, *p["c0"], stride=stride)
        return conv3x3_bn_relu(y, *p["c1"], stride=1)
    if op in (2, 4):   # zoomed: /2 -> conv(s) -> BN -> (x2 back) -> ReLU
        y = downsample_half(x)
        if op == 4:
            y = conv3x3_bn_relu(y, *p["c0"], stride=1)
            y = conv3x3_bn_relu(y, *p["c1"], stride=1, relu=stride == 2)
        else:
            y = conv3x3_bn_relu(y, *p["c0"], stride=1, relu=stride == 2)
        if stride == 1:
            y = torch.relu(resize_bilinear(y, (h, w)))
        return y
    raise ValueError(f"unknown op {op}")


def _refine_3x3(parts: List[torch.Tensor], p: Folded3x3) -> torch.Tensor:
    """ConvNorm(kernel=3) over a channel concat."""
    return conv3x3_bn_relu(torch.cat(parts, dim=-1), *p)


def fast_body(plan: NetworkPlan, fw: Dict, stem: torch.Tensor) -> torch.Tensor:
    """Stem features (1, H8, W8, C) NHWC -> 1/8-resolution class logits
    (1, H8, W8, classes). Mirrors DerivedNet.forward cell for cell;
    reference walk: model_seg.py:293-335."""
    B = plan.num_branch
    outputs = [stem] * B
    by_scale = {8: [stem] * B, 16: [stem] * B, 32: [stem] * B}
    specs = {(c.layer, c.branch): c for c in plan.cells}
    for layer, groups in enumerate(plan.branch_groups):
        for group in groups:
            spec = specs[(layer, group[0])]
            stride = 2 if spec.down else 1
            out = _run_cell(spec.op, outputs[group[0]],
                            fw["cells"][cell_key(layer, group[0])], stride)
            for b in group:
                outputs[b] = out
                by_scale[spec.scale * stride][b] = out

    # BiSeNet aggregation (model_seg.py:298-335)
    pred8 = []
    for b, last in enumerate(plan.lasts):
        o8 = by_scale[8][b]
        if last == 2:
            o16 = by_scale[16][b]
            out = _conv1x1(by_scale[32][b], fw["arms32"][0])
            out = resize_bilinear(out, (o16.shape[1], o16.shape[2]))
            out = _refine_3x3([out, o16], fw["refines32"][0])
            out = _conv1x1(out, fw["arms32"][1])
            out = resize_bilinear(out, (o8.shape[1], o8.shape[2]))
            pred8.append(_refine_3x3([out, o8], fw["refines32"][1]))
        elif last == 1:
            out = _conv1x1(by_scale[16][b], fw["arms16"])
            out = resize_bilinear(out, (o8.shape[1], o8.shape[2]))
            pred8.append(_refine_3x3([out, o8], fw["refines16"]))
        else:
            pred8.append(o8)

    # FFM: 1x1 ConvBnRelu over the branch concat (seg_oprs.py:181-225)
    y = _conv1x1(torch.cat(pred8, dim=-1), fw["ffm"])
    # Head: 3x3 ConvBnRelu -> biased 1x1 to classes (seg_oprs.py:228-274)
    y = conv3x3_bn_relu(y, *fw["head3"])
    return _conv1x1(y, fw["cls"], relu=False)
