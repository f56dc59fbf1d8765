"""Serving path after the stem: the decoded cell body, BiSeNet aggregation,
FFM and head, on NHWC tensors through the hand-written kernels.

Counterpart of the JAX package's models/fast_body.py (`fast_body`,
fast_body.py:217-287), cell for cell:

* every 3x3 conv + folded BN (+ReLU) runs `kernels.conv3x3_bn_relu` (cells,
  refine convs over concats, the head 3x3), at stride 1 or 2;
* 1x1 convs (ARM, FFM, classifier) and FactorizedReduce's two offset
  stride-2 1x1 convs are fp32 matrix products over channels with a fused
  fp32 epilogue, as the JAX package leaves them to XLA einsums;
* zoomed-cell and aggregation resizes run `kernels.resize_bilinear` (both
  axes in one launch; a zoomed stride-1 cell's ReLU fused into its x2);
* with fp32 activations the products (1x1 convs, resizes) sum in float64
  and round once (`_product`; the resize kernel, and on a Block
  `ops.resize.in_float64`), so their bits do not depend on the shapes the
  BLAS library is given: a block of an image split over H gets the whole
  image's;
* a refine conv over a channel concat hands its two NHWC inputs to the conv
  kernel, which reads them in place (no concat is written).

The weights are folded, and split and packed for the tensor-core conv kernel,
once by `fold_weights`, not per call.

The same walk runs on an image split over H across ranks: a map is then a
`parallel.spatial.Block` (this rank's rows, their partition, the exchange),
every 3x3 conv takes its neighbours' halo rows (the kernel's halo mode),
every align-corners resize takes its row window (the contractions of
ops/resize.py `*_rows`, counted as `resize.contraction` by
utils/profiling.py), and the rest is local to the rows. A stride-2 op needs
an even block start (`row_multiple`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.plan import NetworkPlan
from ..kernels.conv import (ConvWeights, conv3x3_bn_relu, input_parts,
                            split_weights)
from ..kernels.resize import resize_bilinear
from ..ops.conv import BatchNorm, Conv
from ..ops.primitives import FactorizedReduce
from ..ops.resize import (downsample_half_rows, in_float64,
                          resize_bilinear_rows)
from ..parallel import spatial
from ..parallel.spatial import Block
from ..utils import profiling
from .derived import DerivedNet, cell_key

# Weights keep fp32 accuracy whatever the activation dtype: they are a few
# hundred KB, and the tensor-core conv kernel takes each weight as hi + lo
# (bf16 halves for bf16 activations, tf32 halves for fp32 ones), split once
# here (`split_weights`); rounding them to bf16 (as the JAX package does for
# the MXU) would add error for nothing.
# (ConvWeights of w (3,3,Ci,Co) HWIO fp32, scale (Co,) fp32, bias (Co,) fp32)
Folded3x3 = Tuple[ConvWeights, torch.Tensor, torch.Tensor]
# (w (Ci,Co) fp32, scale (Co,) or None, bias (Co,))
Folded1x1 = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]


def fold3x3(conv: Conv, bn: BatchNorm, first: Optional[int] = None,
            dtype: torch.dtype = torch.bfloat16) -> Folded3x3:
    """`first`: channels of the first of two inputs, for a conv that is
    applied to a concat (the rest belong to the second; packed for
    `input_parts`); `dtype`: the
    activations' (float32 packs the weights for the 3xTF32 route, any other
    for the bf16 one)."""
    w = conv.weight.detach().permute(2, 3, 1, 0).float().contiguous()
    scale, bias = bn.folded()
    parts = None if first is None else input_parts(first, w.shape[2] - first)
    dtype = torch.float32 if dtype == torch.float32 else torch.bfloat16
    return (split_weights(w, parts, dtype), scale.detach().contiguous(),
            bias.detach().contiguous())


def _w1x1(conv: Conv) -> torch.Tensor:
    return conv.weight.detach()[:, :, 0, 0].t().float().contiguous()


def fold1x1(conv: Conv, bn: Optional[BatchNorm]) -> Folded1x1:
    if bn is None:
        return _w1x1(conv), None, conv.bias.detach().float()
    scale, bias = bn.folded()
    return _w1x1(conv), scale.detach(), bias.detach()


def fold_cell(op: torch.nn.Module, dtype: torch.dtype = torch.bfloat16) -> Dict:
    """One decoded cell's folded weights for `run_cell`; with it, the unit
    the latency LUT prices (latency/measure.serving_route)."""
    if isinstance(op, FactorizedReduce):
        if op.stride == 1:                           # identity skip
            return {}
        scale, bias = op.bn.folded()
        return {"fr": (_w1x1(op.conv1), _w1x1(op.conv2), scale.detach(),
                       bias.detach())}
    p = {"c0": fold3x3(op.conv1, op.bn1, dtype=dtype)}
    if hasattr(op, "conv2"):
        p["c1"] = fold3x3(op.conv2, op.bn2, dtype=dtype)
    return p


@torch.no_grad()
def fold_weights(net: DerivedNet, dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Folded BN and fp32 weights of `net` for fast_stem / fast_body, the 3x3
    convs' packed for activations of `dtype`."""
    stem = [fold3x3(net.stem[0].conv[0], net.stem[0].conv[1], dtype=dtype)]
    for stage in list(net.stem)[1:]:
        stem += [fold3x3(stage.conv1, stage.bn1, dtype=dtype),
                 fold3x3(stage.conv2, stage.bn2, dtype=dtype)]
    fw = {"stem": stem,
          "cells": {k: fold_cell(c._op._op, dtype)
                    for k, c in net.cells.items()},
          "ffm": fold1x1(net.ffm.conv_1x1.conv, net.ffm.conv_1x1.bn),
          "head3": fold3x3(net.heads8.conv_3x3.conv, net.heads8.conv_3x3.bn,
                           dtype=dtype),
          "cls": fold1x1(net.heads8.conv_1x1, None)}
    if hasattr(net, "arms32"):
        fw["arms32"] = [fold1x1(m.conv[0], m.conv[1]) for m in net.arms32]
        # a refine conv reads [the ARM's upsampled output, the branch's map]
        fw["refines32"] = [fold3x3(m.conv[0], m.conv[1], arm[0].shape[1],
                                   dtype)
                           for m, arm in zip(net.refines32, fw["arms32"])]
    if hasattr(net, "arms16"):
        fw["arms16"] = fold1x1(net.arms16.conv[0], net.arms16.conv[1])
        fw["refines16"] = fold3x3(net.refines16.conv[0], net.refines16.conv[1],
                                  fw["arms16"][0].shape[1], dtype)
    return fw


def to_device(tree, device):
    """A tree of folded weights (dicts, lists, tuples of tensors and
    `ConvWeights`) moved to `device`, its tensors contiguous there."""
    if isinstance(tree, ConvWeights):
        return tree.to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device).contiguous()
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def row_multiple(plan: NetworkPlan) -> int:
    """Input rows a block of an image split over H must start at a multiple
    of: the deepest map's stride (the x8 stem, the cells' strides, a zoomed
    cell's half-size map), so that every stride-2 op meets an even block
    start."""
    return max([8] + [c.scale * (2 if c.down or c.op in (2, 4) else 1)
                      for c in plan.cells])


# ---- the walk's operations on a map, or on a Block of one ----


def conv3x3(x, p: Folded3x3, stride: int = 1, relu: bool = True, x2=None):
    """3x3 conv + folded BN (+ReLU) through the conv kernel; on a Block,
    with its halo rows."""
    if isinstance(x, Block):
        return spatial.conv3x3_bn_relu(x, *p, stride=stride, relu=relu, x2=x2)
    return conv3x3_bn_relu(x, *p, stride=stride, relu=relu, x2=x2)


def _local(fn, x, *args, **kw):
    """fn of a map that reads no other rows than its output's: on a Block,
    of its rows."""
    return x.like(fn(x.t, *args, **kw)) if isinstance(x, Block) else fn(
        x, *args, **kw)


def _resize_to(x, like, relu: bool = False):
    """Align-corners resize of x to the size (on Blocks, the rows) of
    `like`, then ReLU where asked."""
    if isinstance(x, Block):
        profiling.count("resize.contraction")
        y = in_float64(resize_bilinear_rows, x,
                       (like.height, like.t.shape[2]), like.part)
        return _local(torch.relu, y) if relu else y
    return resize_bilinear(x, (like.shape[1], like.shape[2]), relu)


def _downsample(x):
    if isinstance(x, Block):
        profiling.count("resize.contraction")
        return in_float64(downsample_half_rows, x)
    return resize_bilinear(x, (x.shape[1] // 2, x.shape[2] // 2))


def _cat(xs):
    """Channel concat."""
    if isinstance(xs[0], Block):
        return xs[0].like(torch.cat([x.t for x in xs], dim=-1))
    return torch.cat(xs, dim=-1)


def _epilogue(y: torch.Tensor, scale, bias, relu: bool, dtype) -> torch.Tensor:
    if scale is not None:
        y = y * scale
    y = y + bias
    if relu:
        y = torch.relu(y)
    return y.to(dtype)


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w over channels, in fp32; for fp32 x in float64, as
    `ops.resize.in_float64` runs the resizes."""
    acc = torch.float64 if x.dtype == torch.float32 else torch.float32
    return torch.matmul(x.to(acc), w.to(acc))


def conv1x1(x: torch.Tensor, p: Folded1x1, relu: bool = True) -> torch.Tensor:
    """1x1 conv + folded BN (+ReLU): a product over channels (`_product`)
    and its epilogue, rounded once to x's dtype. The unit the latency LUT
    prices for a 1x1 ConvNorm, the FFM's and the head's classifier."""
    w, scale, bias = p
    return _epilogue(_product(x, w), scale, bias, relu, x.dtype)


def _factorized_reduce(x, p):
    """'skip' at stride 2 (operations.py:521-526): 1x1 convs at pixel
    offsets (0,0) and (1,1), stride 2, channel concat, BN, ReLU. On a
    Block the offsets are global only from an even block start."""
    if isinstance(x, Block):
        if x.lo % 2:
            raise ValueError(f"FactorizedReduce over a block starting at odd "
                             f"row {x.lo} would sample the wrong pixels")
        return x.like(_factorized_reduce(x.t, p),
                      x.part.map(lambda b: b // 2, x.height // 2))
    wa, wb, scale, bias = p["fr"]
    y = torch.cat([_product(x[:, 0::2, 0::2], wa),
                   _product(x[:, 1::2, 1::2], wb)], dim=-1)
    return _epilogue(y, scale, bias, True, x.dtype)


def run_cell(op: int, x, p: Dict, stride: int):
    """One decoded cell (ops/primitives.py classes) on an NHWC input (or a
    Block of one), on `fold_cell`'s weights: the unit the latency LUT
    prices for a cell's op."""
    if op == 0:
        return x if stride == 1 else _factorized_reduce(x, p)
    if op == 1:    # conv
        return conv3x3(x, p["c0"], stride)
    if op == 3:    # conv_2x
        return conv3x3(conv3x3(x, p["c0"], stride), p["c1"])
    if op in (2, 4):   # zoomed: /2 -> conv(s) -> BN -> (x2 back) -> ReLU
        y = _downsample(x)
        if op == 4:
            y = conv3x3(y, p["c0"])
            y = conv3x3(y, p["c1"], relu=stride == 2)
        else:
            y = conv3x3(y, p["c0"], relu=stride == 2)
        if stride == 1:
            y = _resize_to(y, x, relu=True)
        return y
    raise ValueError(f"unknown op {op}")


def _refine_3x3(a, b, p: Folded3x3):
    """ConvNorm(kernel=3) over the channel concat [a, b], which the conv
    kernel reads from the two tensors."""
    return conv3x3(a, p, x2=b)


def fast_body(plan: NetworkPlan, fw: Dict, stem):
    """Stem features (1, H8, W8, C) NHWC -> 1/8-resolution class logits
    (1, H8, W8, classes); with a Block of the stem features, the Block of
    the logits. Mirrors DerivedNet.forward cell for cell; reference walk:
    model_seg.py:293-335. Spans: `infer.cells`, `infer.aggregate`,
    `infer.head`."""
    B = plan.num_branch
    outputs = [stem] * B
    by_scale = {8: [stem] * B, 16: [stem] * B, 32: [stem] * B}
    specs = {(c.layer, c.branch): c for c in plan.cells}
    with profiling.span("infer.cells"):
        for layer, groups in enumerate(plan.branch_groups):
            for group in groups:
                spec = specs[(layer, group[0])]
                stride = 2 if spec.down else 1
                out = run_cell(spec.op, outputs[group[0]],
                               fw["cells"][cell_key(layer, group[0])], stride)
                for b in group:
                    outputs[b] = out
                    by_scale[spec.scale * stride][b] = out

    # BiSeNet aggregation (model_seg.py:298-335)
    with profiling.span("infer.aggregate"):
        pred8 = []
        for b, last in enumerate(plan.lasts):
            o8 = by_scale[8][b]
            if last == 2:
                o16 = by_scale[16][b]
                out = _local(conv1x1, by_scale[32][b], fw["arms32"][0])
                out = _refine_3x3(_resize_to(out, o16), o16,
                                  fw["refines32"][0])
                out = _local(conv1x1, out, fw["arms32"][1])
                pred8.append(_refine_3x3(_resize_to(out, o8), o8,
                                         fw["refines32"][1]))
            elif last == 1:
                out = _local(conv1x1, by_scale[16][b], fw["arms16"])
                pred8.append(_refine_3x3(_resize_to(out, o8), o8,
                                         fw["refines16"]))
            else:
                pred8.append(o8)

    with profiling.span("infer.head"):
        # FFM: 1x1 ConvBnRelu over the branch concat (seg_oprs.py:181-225)
        y = _local(conv1x1, _cat(pred8), fw["ffm"])
        # Head: 3x3 ConvBnRelu -> biased 1x1 to classes (seg_oprs.py:228-274)
        y = conv3x3(y, fw["head3"])
        return _local(conv1x1, y, fw["cls"], relu=False)
