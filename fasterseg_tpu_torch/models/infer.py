"""Batch-1 eval-mode serving: kernel stem + kernel body + fused head.

Counterpart of the JAX package's models/infer.py. The five stem convs, every
3x3 conv of the body and the head run the hand-written conv kernel
(kernels/conv.py); the class map comes from the fused upsample-argmax kernel
(kernels/fused.py), so full-resolution logits are never written for it; the
full-resolution logits come from the resize kernel (kernels/resize.py).

`.logits` also runs on an image split over H across ranks: given this rank's
`parallel.spatial.Block` of the image, it returns its Block of the
full-resolution logits, every conv in halo mode (models/fast_body.py).
"""

from __future__ import annotations

import copy
from typing import Dict, Sequence, Union

import torch

from ..core.plan import NetworkPlan
from ..kernels import resolve_device
from ..kernels.fused import upsample8_argmax, upsample8_argmax_plain
from ..kernels.resize import resize_bilinear
from ..ops.conv import Conv
from ..ops.resize import in_float64, scale_by, scale_by_rows
from ..parallel.spatial import Block
from ..utils import profiling
from .derived import DerivedNet
from .fast_body import (Folded3x3, conv3x3, fast_body, fold_weights,
                        row_multiple, to_device)


def fast_stem(stem: Sequence[Folded3x3], x):
    """The 5 stem convs (ConvNorm + 2x BasicResidual2x, derived.Stem)
    through the conv kernel: stride 2 at stage0 and at the stage1/stage2
    entries. x: (1, H, W, 3) in the compute dtype -> (1, H/8, W/8, C), or
    a Block of it -> the Block of the output."""
    y = conv3x3(x, stem[0], stride=2)
    for i in (1, 3):
        y = conv3x3(y, stem[i], stride=2)
        y = conv3x3(y, stem[i + 1])
    return y


class InferenceRunner:
    """Eval-mode forwards of a derived network.

    .logits(x)   -> (1, H, W, classes) full-resolution logits: the x8
                    align-corners resize of the 1/8 logits (reference
                    contract), by the resize kernel (`scale_by`'s
                    contraction on the plain path and on a Block)
    .classmap(x) -> (1, H, W) int32 class map from the fused upsample-argmax

    x is (1, H, W, 3) NHWC. `.logits` also takes this rank's
    `parallel.spatial.Block` of an image split over H (blocks starting at
    multiples of `row_multiple` input rows) and returns its Block of the
    logits; the kernel path only. `fast_stem_enabled=False` means the plain
    network throughout (`net`, its class map too): the reference the kernel
    path is held against. BN folding and weight casting happen here, once.

    Each call is one unit span, `infer.classmap` or `infer.logits`, over the
    stage spans `infer.stem`, fast_body's `infer.cells`, `infer.aggregate`
    and `infer.head`, and `infer.upsample` (utils/profiling.py).
    """

    def __init__(self, plan: NetworkPlan, net: DerivedNet,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device] = "cuda",
                 fast_stem_enabled: bool = True):
        self.plan = plan
        self.dtype = dtype
        self.device = resolve_device(device)
        self.fast_stem_enabled = fast_stem_enabled
        self.folded: Dict = {}
        self.net = None
        if fast_stem_enabled:
            self.folded = to_device(fold_weights(net, dtype), self.device)
        else:
            # the plain network: convs in the compute dtype, BN in fp32
            self.net = copy.deepcopy(net).to(self.device).eval()
            for m in self.net.modules():
                if isinstance(m, Conv):
                    m.to(dtype)

    @property
    def row_multiple(self) -> int:
        """Input rows a block of an image split over H starts at a
        multiple of (`fast_body.row_multiple`)."""
        return row_multiple(self.plan)

    @torch.inference_mode()
    def p8(self, x):
        """1/8-resolution logits (1, H/8, W/8, classes)."""
        if isinstance(x, Block):
            if not self.fast_stem_enabled:
                raise ValueError("a Block (an image split over H) runs the "
                                 "kernel path only")
            x = x.like(x.t.to(device=self.device, dtype=self.dtype)
                       .contiguous())
        else:
            x = x.to(device=self.device, dtype=self.dtype).contiguous()
            if not self.fast_stem_enabled:
                return self.net(x, upsample=False)
        with profiling.span("infer.stem"):
            stem = fast_stem(self.folded["stem"], x)
        return fast_body(self.plan, self.folded, stem)

    @torch.inference_mode()
    def logits(self, x):
        with profiling.span("infer.logits"):
            p8 = self.p8(x)
            with profiling.span("infer.upsample"):
                if isinstance(p8, Block):
                    profiling.count("resize.contraction")
                    return in_float64(scale_by_rows, p8, 8)
                if not self.fast_stem_enabled:
                    return in_float64(scale_by, p8, 8)
                return resize_bilinear(p8, (p8.shape[1] * 8, p8.shape[2] * 8))

    @torch.inference_mode()
    def classmap(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.span("infer.classmap"):
            out_hw = (x.shape[1], x.shape[2])
            p8 = self.p8(x)
            with profiling.span("infer.upsample"):
                if not self.fast_stem_enabled:
                    return upsample8_argmax_plain(p8, out_hw)
                return upsample8_argmax(p8, out_hw)
