"""Batch-1 eval-mode serving: kernel stem + kernel body + fused head.

Counterpart of the JAX package's models/infer.py. The five stem convs, every
3x3 conv of the body and the head run the hand-written conv kernel
(kernels/conv.py); the class map comes from the fused upsample-argmax kernel
(kernels/fused.py), so full-resolution logits are never written for it.
"""

from __future__ import annotations

import copy
from typing import Dict, Sequence, Union

import torch

from ..core.plan import NetworkPlan
from ..kernels.conv import conv3x3_bn_relu
from ..kernels.fused import upsample8_argmax, upsample8_argmax_plain
from ..ops.conv import Conv
from ..ops.resize import scale_by
from .derived import DerivedNet
from .fast_body import Folded3x3, fast_body, fold_weights


def fast_stem(stem: Sequence[Folded3x3], x: torch.Tensor) -> torch.Tensor:
    """The 5 stem convs (ConvNorm + 2x BasicResidual2x, derived.Stem)
    through the conv kernel: stride 2 at stage0 and at the stage1/stage2
    entries. x: (1, H, W, 3) in the compute dtype -> (1, H/8, W/8, C)."""
    y = conv3x3_bn_relu(x, *stem[0], stride=2)
    for i in (1, 3):
        y = conv3x3_bn_relu(y, *stem[i], stride=2)
        y = conv3x3_bn_relu(y, *stem[i + 1], stride=1)
    return y


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on; CUDA must be present when asked
    for (the default), the CPU is used only when the caller names it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return device


class InferenceRunner:
    """Eval-mode forwards of a derived network.

    .logits(x)   -> (1, H, W, classes) full-resolution logits: x8 `scale_by`
                    of the 1/8 logits (reference contract)
    .classmap(x) -> (1, H, W) int32 class map from the fused upsample-argmax

    x is (1, H, W, 3) NHWC. `fast_body_enabled=False` runs the kernel stem
    and the plain body of `net`; `fast_stem_enabled=False` runs `net`
    alone, plain throughout (its class map too), which makes it the
    reference the kernel path is held against. BN folding and weight
    casting happen here, once.
    """

    def __init__(self, plan: NetworkPlan, net: DerivedNet,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device] = "cuda",
                 fast_stem_enabled: bool = True,
                 fast_body_enabled: bool = True):
        self.plan = plan
        self.dtype = dtype
        self.device = resolve_device(device)
        self.fast_stem_enabled = fast_stem_enabled
        self.fast_body_enabled = fast_body_enabled and fast_stem_enabled
        self.folded: Dict = {}
        self.net = None
        if fast_stem_enabled:
            self.folded = _to(fold_weights(net), self.device)
        if not self.fast_body_enabled:
            # the plain network: convs in the compute dtype, BN in fp32
            self.net = copy.deepcopy(net).to(self.device).eval()
            for m in self.net.modules():
                if isinstance(m, Conv):
                    m.to(dtype)

    @torch.inference_mode()
    def p8(self, x: torch.Tensor) -> torch.Tensor:
        """1/8-resolution logits (1, H/8, W/8, classes)."""
        x = x.to(device=self.device, dtype=self.dtype).contiguous()
        if not self.fast_stem_enabled:
            return self.net(x, upsample=False)
        stem = fast_stem(self.folded["stem"], x)
        if self.fast_body_enabled:
            return fast_body(self.plan, self.folded, stem)
        return self.net(x, stem_out=stem, upsample=False)

    @torch.inference_mode()
    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return scale_by(self.p8(x), 8)

    @torch.inference_mode()
    def classmap(self, x: torch.Tensor) -> torch.Tensor:
        out_hw = (x.shape[1], x.shape[2])
        if not self.fast_stem_enabled:
            return upsample8_argmax_plain(self.p8(x), out_hw)
        return upsample8_argmax(self.p8(x), out_hw)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device).contiguous()
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree
