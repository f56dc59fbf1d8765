"""Conv / BN building blocks as `torch.nn` modules on NHWC tensors.

Counterparts of the reference's `ConvNorm` (search/operations.py:42-128) and
`ConvBnRelu` (search/seg_oprs.py:17-39). Parameter and buffer names are
torch's own (`weight`, `bias`, `running_mean`, ...) and submodule names are
the reference's (`conv.0`/`conv.1` for ConvNorm, `conv`/`bn` for
ConvBnRelu), so a reference `Network_Multi_Path_Infer` state_dict loads as
it is.

Activations are NHWC, as in the JAX package; `Conv` hands torch's conv a
permuted (channels-last) view and permutes the result back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def conv_padding(kernel_size: int, stride: int, dilation: int = 1,
                 padding: Optional[int] = None) -> int:
    """Reference ConvNorm default: pad = ceil((d*(k-1)+1-s)/2)
    (operations.py:54-58), symmetric on H and W."""
    if padding is None:
        padding = int(np.ceil((dilation * (kernel_size - 1) + 1 - stride) / 2.0))
    return padding


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """BN(eval) as y = x*scale + bias."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


class Conv(nn.Conv2d):
    """Bare conv with torch-style explicit padding on NHWC tensors."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = False, padding: Optional[int] = None):
        super().__init__(c_in, c_out, kernel_size, stride,
                         conv_padding(kernel_size, stride, dilation, padding),
                         dilation, groups, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.BatchNorm2d):
    """Eval-mode BN over the last (channel) axis of an NHWC tensor: running
    statistics, eps 1e-5. Training-mode statistics are not part of the
    serving path."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)

    def folded(self):
        """(scale, bias) in float32 with BN(x) == x * scale + bias."""
        return fold_bn(self.weight.float(), self.bias.float(),
                       self.running_mean.float(), self.running_var.float(),
                       self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("BatchNorm runs in eval mode only")
        scale, bias = self.folded()
        return (x.float() * scale + bias).to(x.dtype)


class ConvNorm(nn.Module):
    """conv -> BN -> ReLU (reference ConvNorm, slimmable=False path,
    operations.py:76-82): `conv` is Sequential(conv, bn, relu)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = False, padding: Optional[int] = None):
        super().__init__()
        groups = 1 if kernel_size == 1 else groups
        self.conv = nn.Sequential(
            Conv(c_in, c_out, kernel_size, stride, dilation, groups, bias,
                 padding),
            BatchNorm(c_out), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ConvBnRelu(nn.Module):
    """Reference seg_oprs.ConvBnRelu: conv with explicit pad, optional
    BN / ReLU / bias (seg_oprs.py:17-39)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int,
                 pad: int, dilation: int = 1, groups: int = 1,
                 has_bn: bool = True, has_relu: bool = True,
                 has_bias: bool = False):
        super().__init__()
        self.conv = Conv(c_in, c_out, kernel_size, stride, dilation, groups,
                         has_bias, pad)
        self.bn = BatchNorm(c_out) if has_bn else None
        self.has_relu = has_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.has_relu else x
