"""Slimmable (universally width-switchable) ops on NHWC tensors, masked.

Counterparts of the JAX package's ops/slimmable.py, which are the
reference's sliced `USConv2d` / `USBatchNorm2d` ops (search/slimmable_ops.py)
and the slimmable paths of the five primitives (search/operations.py). As in
the JAX package, every tensor keeps its maximum width and a width is a
channel mask:

* A conv on an input whose channels beyond k are zero equals the conv on the
  k-sliced input; masking the output beyond k' equals slicing it. So one
  graph serves every width, and the width index never has to reach the host:
  it selects a row of a mask table (and of the BN tables) on the device.
* Widths arrive as (index, score) pairs from `search.gumbel.sample_ratios`:
  the index selects mask and BN rows, the score carries the straight-through
  gradient (models/supernet.py).
* `SlimBatchNorm` keeps one parameter and statistic row per width, as the
  reference keeps one BN per width. In train mode it normalises with the
  batch statistics and moves the selected row's running statistics with the
  *unbiased* batch variance, flax-style `ra * 0.9 + new * 0.1`. (The stems,
  refines and heads use `ops.conv.BatchNorm`, whose running variance moves
  with the biased one.) The masked channels' statistics are 0, so the
  selected row's entries beyond the active prefix decay towards 0, as in the
  JAX package; those entries are never read at that width.

`make_divisible` (slimmable_ops.py:5-18) gives the active channel count.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .conv import Conv, upcast
from .resize import downsample_half, resize_bilinear


def make_divisible(v: float, divisor: int = 8, min_value: int = 1) -> int:
    """Round a channel count to a multiple of `divisor`, never dropping more
    than 10 % (slimmable_ops.py:5-18)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@functools.lru_cache(maxsize=None)
def width_mask_table(c_max: int, width_mult_list: Tuple[float, ...]
                     ) -> np.ndarray:
    """(num_widths, c_max) float32: row w has make_divisible(c_max*w) ones."""
    table = np.zeros((len(width_mult_list), c_max), np.float32)
    for i, w in enumerate(width_mult_list):
        table[i, :make_divisible(c_max * w)] = 1.0
    return table


def width_index(width: float, width_mult_list: Sequence[float]) -> int:
    """Index of a forced width in the width list."""
    for i, w in enumerate(width_mult_list):
        if abs(w - width) < 1e-9:
            return i
    raise ValueError(f"width {width} not in {width_mult_list}")


@functools.lru_cache(maxsize=None)
def _device_table(table_fn, key, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """A host table copied to `device` once (outside inference mode, so a
    training forward may save it for backward)."""
    with torch.inference_mode(False):
        return torch.from_numpy(table_fn(*key)).to(device=device, dtype=dtype)


def row(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 0-d index tensor on the device, as a gather.
    (Indexing with a 0-d tensor reads it to the host first: one stall of
    the stream per mask and BN row, tens of thousands a search step.)"""
    return torch.index_select(table, 0, idx.reshape(1))[0]


def width_mask(c_max: int, width_mult_list: Tuple[float, ...],
               idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The (c_max,) channel mask of width index `idx` (a 0-d device tensor),
    in `like`'s dtype and on its device."""
    table = _device_table(width_mask_table, (c_max, tuple(width_mult_list)),
                          like.dtype, like.device)
    return row(table, idx)


class _StatisticsUpdates(threading.local):
    frozen = False


_UPDATES = _StatisticsUpdates()


@contextlib.contextmanager
def frozen_running_statistics():
    """Inside it (in this thread), `SlimBatchNorm` in train mode leaves its
    running statistics as they are. Activation checkpointing recomputes a
    forward under it, so the recompute does not move them a second time."""
    before = _UPDATES.frozen
    _UPDATES.frozen = True
    try:
        yield
    finally:
        _UPDATES.frozen = before


class SlimConv(nn.Module):
    """Full-width conv between an input and an output channel mask
    (USConv2d, slimmable_ops.py:21-48)."""

    def __init__(self, c_max_in: int, c_max_out: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1,
                 width_mult_list: Tuple[float, ...] = (1.0,),
                 padding: Optional[int] = None):
        super().__init__()
        self.wml = tuple(width_mult_list)
        self.c_max_in, self.c_max_out = c_max_in, c_max_out
        self.conv = Conv(c_max_in, c_max_out, kernel_size, stride, dilation,
                         padding=padding)

    def forward(self, x, in_idx, out_idx):
        x = x * width_mask(self.c_max_in, self.wml, in_idx, x)
        y = self.conv(x)
        return y * width_mask(self.c_max_out, self.wml, out_idx, y)


class SlimBatchNorm(nn.Module):
    """Per-width BN rows (USBatchNorm2d, slimmable_ops.py:51-70) over the
    last axis of an NHWC tensor: `weight`, `bias`, `running_mean` and
    `running_var` are (num_widths, features). Train mode normalises with the
    batch mean and biased variance and moves the selected row towards the
    batch mean and the unbiased variance; eval mode uses the selected row."""

    def __init__(self, features: int, num_widths: int = 1,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.features, self.num_widths = features, num_widths
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_widths, features))
        self.bias = nn.Parameter(torch.zeros(num_widths, features))
        self.register_buffer("running_mean", torch.zeros(num_widths, features))
        self.register_buffer("running_var", torch.ones(num_widths, features))

    def forward(self, x, width_idx):
        xf = upcast(x)
        if self.training:
            var, mean = torch.var_mean(xf, dim=(0, 1, 2), unbiased=False)
            if not _UPDATES.frozen:
                self._update(width_idx, mean.detach(), var.detach(),
                             x.shape[0] * x.shape[1] * x.shape[2])
        else:
            mean = row(self.running_mean, width_idx)
            var = row(self.running_var, width_idx)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * row(self.weight, width_idx) + row(self.bias, width_idx)
        return y.to(x.dtype)

    @torch.no_grad()
    def _update(self, idx, mean, var, n: int) -> None:
        m = self.momentum
        unbiased = var * n / max(n - 1, 1)
        for buf, new in ((self.running_mean, mean),
                         (self.running_var, unbiased)):
            buf.index_copy_(0, idx.reshape(1),
                            (row(buf, idx) * m + new * (1 - m))
                            .to(buf.dtype)[None])


class _SlimOp(nn.Module):
    """Shared parts of the five slim primitives: the width list and the
    output mask."""

    def __init__(self, c_max_in: int, c_max_out: int, stride: int,
                 width_mult_list: Tuple[float, ...]):
        super().__init__()
        self.c_max_in, self.c_max_out = c_max_in, c_max_out
        self.stride = stride
        self.wml = tuple(width_mult_list)

    def _conv(self, c_in, k=3, stride=1, padding=1):
        return SlimConv(c_in, self.c_max_out, k, stride,
                        width_mult_list=self.wml, padding=padding)

    def _bn(self):
        return SlimBatchNorm(self.c_max_out, len(self.wml))

    def _relu_mask(self, y, out_idx):
        return F.relu(y) * width_mask(self.c_max_out, self.wml, out_idx, y)


class SlimBasicResidual1x(_SlimOp):
    """Slimmable 'conv' (operations.py:131-200): 3x3 conv, BN, ReLU."""

    def __init__(self, c_max_in, c_max_out, stride=1, width_mult_list=(1.0,)):
        super().__init__(c_max_in, c_max_out, stride, width_mult_list)
        self.conv1 = self._conv(c_max_in, stride=stride)
        self.bn1 = self._bn()

    def forward(self, x, in_idx, out_idx):
        y = self.bn1(self.conv1(x, in_idx, out_idx), out_idx)
        return self._relu_mask(y, out_idx)


class SlimBasicResidualDownup1x(_SlimOp):
    """Slimmable zoomed conv (operations.py:203-277): bilinear /2, 3x3
    conv, BN, bilinear back at stride 1, ReLU."""

    def __init__(self, c_max_in, c_max_out, stride=1, width_mult_list=(1.0,)):
        super().__init__(c_max_in, c_max_out, stride, width_mult_list)
        self.conv1 = self._conv(c_max_in)
        self.bn1 = self._bn()

    def forward(self, x, in_idx, out_idx):
        h, w = x.shape[-3], x.shape[-2]
        y = self.conv1(downsample_half(x), in_idx, out_idx)
        y = self.bn1(y, out_idx)
        if self.stride == 1:
            y = resize_bilinear(y, (h, w))
        return self._relu_mask(y, out_idx)


class SlimBasicResidual2x(_SlimOp):
    """Slimmable double conv (operations.py:280-359)."""

    def __init__(self, c_max_in, c_max_out, stride=1, width_mult_list=(1.0,)):
        super().__init__(c_max_in, c_max_out, stride, width_mult_list)
        self.conv1 = self._conv(c_max_in, stride=stride)
        self.bn1 = self._bn()
        self.conv2 = self._conv(c_max_out)
        self.bn2 = self._bn()

    def forward(self, x, in_idx, out_idx):
        y = self._relu_mask(self.bn1(self.conv1(x, in_idx, out_idx), out_idx),
                            out_idx)
        y = self.bn2(self.conv2(y, out_idx, out_idx), out_idx)
        return self._relu_mask(y, out_idx)


class SlimBasicResidualDownup2x(_SlimOp):
    """Slimmable zoomed double conv (operations.py:362-446)."""

    def __init__(self, c_max_in, c_max_out, stride=1, width_mult_list=(1.0,)):
        super().__init__(c_max_in, c_max_out, stride, width_mult_list)
        self.conv1 = self._conv(c_max_in)
        self.bn1 = self._bn()
        self.conv2 = self._conv(c_max_out)
        self.bn2 = self._bn()

    def forward(self, x, in_idx, out_idx):
        h, w = x.shape[-3], x.shape[-2]
        y = self.conv1(downsample_half(x), in_idx, out_idx)
        y = self._relu_mask(self.bn1(y, out_idx), out_idx)
        y = self.bn2(self.conv2(y, out_idx, out_idx), out_idx)
        if self.stride == 1:
            y = resize_bilinear(y, (h, w))
        return self._relu_mask(y, out_idx)


def _reduce_gather_table(c_max_out: int, wml: Tuple[float, ...]
                         ) -> np.ndarray:
    """(num_widths, c_max_out) int64: for each width, the channel of
    cat([a, b, 0]) (two halves and one zero channel) that each output
    channel takes, so that the k/2 active channels of each half sit side by
    side in [0, k) as in the reference's concat of two sliced halves."""
    half = c_max_out // 2
    table = np.full((len(wml), c_max_out), 2 * half, np.int64)
    for i, wm in enumerate(wml):
        k_half = make_divisible(half * wm)
        table[i, :k_half] = np.arange(k_half)
        table[i, k_half:2 * k_half] = half + np.arange(k_half)
    return table


class SlimFactorizedReduce(_SlimOp):
    """Slimmable 'skip' (operations.py:449-534). Stride 1: a 1x1 conv, BN,
    ReLU (a real conv when slimmable, operations.py:460-463). Stride 2: two
    1x1 stride-2 convs, the second offset by one pixel, each to
    make_divisible(C/2 * w) channels and concatenated, then BN and ReLU."""

    def __init__(self, c_max_in, c_max_out, stride=1, width_mult_list=(1.0,)):
        super().__init__(c_max_in, c_max_out, stride, width_mult_list)
        if stride == 1:
            self.conv1 = self._conv(c_max_in, k=1, padding=0)
        else:
            half = c_max_out // 2
            self.conv1 = Conv(c_max_in, half, 1, 2, padding=0)
            self.conv2 = Conv(c_max_in, half, 1, 2, padding=0)
        self.bn = self._bn()

    def forward(self, x, in_idx, out_idx):
        if self.stride == 1:
            y = self.conv1(x, in_idx, out_idx)
            return self._relu_mask(self.bn(y, out_idx), out_idx)
        half = self.c_max_out // 2
        xm = x * width_mask(self.c_max_in, self.wml, in_idx, x)
        a = self.conv1(xm)
        b = self.conv2(xm[:, 1:, 1:, :])
        # each half masked to its k/2 channels, then the two active blocks
        # gathered side by side (the JAX package rolls b's block into
        # place; the same selection)
        half_mask = width_mask(half, self.wml, out_idx, a)
        zero = a.new_zeros(a.shape[:-1] + (1,))
        cat = torch.cat([a * half_mask, b * half_mask, zero], -1)
        gather = row(_device_table(_reduce_gather_table,
                                   (self.c_max_out, self.wml), torch.int64,
                                   x.device), out_idx)
        y = torch.index_select(cat, -1, gather)
        return self._relu_mask(self.bn(y, out_idx), out_idx)


SLIM_OP_CLASSES = (
    SlimFactorizedReduce,
    SlimBasicResidual1x,
    SlimBasicResidualDownup1x,
    SlimBasicResidual2x,
    SlimBasicResidualDownup2x,
)
