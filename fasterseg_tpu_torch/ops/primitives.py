"""The five searchable primitives: derived (fixed-width) variants.

Counterparts of search/operations.py (slimmable=False paths) used by the
decoded inference networks, with the reference's child names (`conv1`,
`bn1`, `conv2`, `bn2`, `bn`). Index-aligned with core.genotype.PRIMITIVES:

  0 skip           FactorizedReduce (identity at stride 1; operations.py:449-534)
  1 conv           BasicResidual1x   (operations.py:131-200)
  2 conv_downup    BasicResidualDownup1x: "zoomed" conv (operations.py:203-277)
  3 conv_2x        BasicResidual2x   (operations.py:280-359)
  4 conv_2x_downup BasicResidualDownup2x (operations.py:362-446)

All NHWC. The downup ops sample with align-corners bilinear (resize.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .conv import BatchNorm, Conv
from .resize import downsample_half, resize_bilinear


class BasicResidual1x(nn.Module):
    """3x3 conv -> BN -> ReLU."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        dilation = 1 if stride == 2 else dilation
        self.conv1 = Conv(c_in, c_out, 3, stride, dilation, padding=dilation)
        self.bn1 = BatchNorm(c_out)

    def forward(self, x):
        return F.relu(self.bn1(self.conv1(x)))


class BasicResidualDownup1x(nn.Module):
    """Zoomed conv: bilinear /2 -> 3x3 conv (stride 1) -> BN ->
    (bilinear x2 back if stride==1) -> ReLU (operations.py:270-277)."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.stride = stride
        dilation = 1 if stride == 2 else dilation
        self.conv1 = Conv(c_in, c_out, 3, 1, dilation, padding=dilation)
        self.bn1 = BatchNorm(c_out)

    def forward(self, x):
        h, w = x.shape[-3], x.shape[-2]
        out = self.bn1(self.conv1(downsample_half(x)))
        if self.stride == 1:
            out = resize_bilinear(out, (h, w))
        return F.relu(out)


class BasicResidual2x(nn.Module):
    """Two stacked conv+BN+ReLU blocks; the first carries the stride."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        dilation = 1 if stride == 2 else dilation
        self.conv1 = Conv(c_in, c_out, 3, stride, dilation, padding=dilation)
        self.bn1 = BatchNorm(c_out)
        self.conv2 = Conv(c_out, c_out, 3, 1, dilation, padding=dilation)
        self.bn2 = BatchNorm(c_out)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class BasicResidualDownup2x(nn.Module):
    """Zoomed double conv (operations.py:436-446): /2 -> conv+BN+ReLU ->
    conv+BN -> (x2 back if stride==1) -> ReLU."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.stride = stride
        dilation = 1 if stride == 2 else dilation
        self.conv1 = Conv(c_in, c_out, 3, 1, dilation, padding=dilation)
        self.bn1 = BatchNorm(c_out)
        self.conv2 = Conv(c_out, c_out, 3, 1, dilation, padding=dilation)
        self.bn2 = BatchNorm(c_out)

    def forward(self, x):
        h, w = x.shape[-3], x.shape[-2]
        out = F.relu(self.bn1(self.conv1(downsample_half(x))))
        out = self.bn2(self.conv2(out))
        if self.stride == 1:
            out = resize_bilinear(out, (h, w))
        return F.relu(out)


class FactorizedReduce(nn.Module):
    """'skip': identity at stride 1 (non-slimmable, operations.py:533-534);
    at stride 2, two offset 1x1 stride-2 convs concatenated on channels,
    then BN + ReLU (operations.py:521-526)."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        if stride == 2:
            self.conv1 = Conv(c_in, c_out // 2, 1, 2, padding=0)
            self.conv2 = Conv(c_in, c_out // 2, 1, 2, padding=0)
            self.bn = BatchNorm(c_out)

    def forward(self, x):
        if self.stride == 1:
            return x
        out = torch.cat([self.conv1(x), self.conv2(x[:, 1:, 1:, :])], dim=-1)
        return F.relu(self.bn(out))


# PRIMITIVES-indexed constructors: OP_CLASSES[i](c_in, c_out, stride)
OP_CLASSES = (
    FactorizedReduce,
    BasicResidual1x,
    BasicResidualDownup1x,
    BasicResidual2x,
    BasicResidualDownup2x,
)


def make_op(op_idx: int, c_in: int, c_out: int, stride: int) -> nn.Module:
    return OP_CLASSES[op_idx](c_in, c_out, stride)
