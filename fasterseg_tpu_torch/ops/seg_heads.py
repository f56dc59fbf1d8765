"""Segmentation head and feature fusion (BiSeNet-derived, search/seg_oprs.py).

`FeatureFusion.forward` in the reference defines a channel-attention branch
but bypasses it (returns the 1x1 conv directly, seg_oprs.py:219-225); only
the effective behaviour is built here, so the reference's
`ffm.channel_attention.*` weights are unused keys when a state_dict loads.
"""

from __future__ import annotations

import torch.nn as nn

from .conv import Conv, ConvBnRelu


class FeatureFusion(nn.Module):
    """A single 1x1 ConvBnRelu over the concatenated branch features
    (seg_oprs.py:181-225)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv_1x1 = ConvBnRelu(c_in, c_out, 1, 1, 0)

    def forward(self, x):
        return self.conv_1x1(x)


class Head(nn.Module):
    """3x3 ConvBnRelu -> biased 1x1 conv to classes (seg_oprs.py:228-274).
    mid = in_planes when in <= 256 else in//2 (seg_oprs.py:230-243)."""

    def __init__(self, c_in: int, num_classes: int = 19):
        super().__init__()
        mid = c_in if c_in <= 256 else c_in // 2
        self.conv_3x3 = ConvBnRelu(c_in, mid, 3, 1, 1)
        self.conv_1x1 = Conv(mid, num_classes, 1, 1, bias=True, padding=0)

    def forward(self, x):
        return self.conv_1x1(self.conv_3x3(x))
