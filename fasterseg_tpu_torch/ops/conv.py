"""Conv / BN building blocks as `torch.nn` modules on NHWC tensors.

Counterparts of the reference's `ConvNorm` (search/operations.py:42-128) and
`ConvBnRelu` (search/seg_oprs.py:17-39). Parameter and buffer names are
torch's own (`weight`, `bias`, `running_mean`, ...) and submodule names are
the reference's (`conv.0`/`conv.1` for ConvNorm, `conv`/`bn` for
ConvBnRelu), so a reference `Network_Multi_Path_Infer` state_dict loads as
it is.

Activations are NHWC, as in the JAX package; `Conv` hands torch's conv a
permuted (channels-last) view and permutes the result back; on bf16
activations it casts its fp32 parameters to bf16 on each call and adds the
bias after the conv, as flax's `Conv(dtype=bf16, param_dtype=float32)`.
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


def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or as it is when it is fp64 already: training keeps its
    statistics, upsampled logits and losses in fp32 whatever the compute
    dtype, and a float64 network (a reference for fp32 rounding) stays in
    float64."""
    return x if x.dtype == torch.float64 else x.float()


def batch_moments(xf: torch.Tensor, mesh=None):
    """(mean, biased variance, count) over N, H, W of an NHWC tensor: of
    this batch, or with `mesh` (a `parallel.Mesh`) of the global batch
    whose equal shards the ranks hold, differentiably.

    Each rank's mean and variance are gathered and merged in float64 by the
    pairwise form of Chan et al. with equal counts (each variance taken
    about its own mean first, so no E[x^2] - E[x]^2 cancels). Every rank
    computes the same merge, so the statistics are identical on all of
    them; with one rank and fp32 inputs it returns the local mean and
    variance bit for bit."""
    var, mean = torch.var_mean(xf, dim=(0, 1, 2), unbiased=False)
    n = xf.shape[0] * xf.shape[1] * xf.shape[2]
    if mesh is None:
        return mean, var, n
    means, variances = mesh.gather(torch.stack([mean, var]).double(),
                                   differentiable=True).unbind(1)
    gmean = means.mean(0)
    gvar = (variances + (means - gmean) ** 2).mean(0)
    return gmean.to(xf.dtype), gvar.to(xf.dtype), n * mesh.world


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
        x = x.permute(0, 3, 1, 2)
        if x.dtype == self.weight.dtype:
            y = super().forward(x)
        else:
            # flax's Conv(dtype=bf16, param_dtype=float32), as a bf16
            # supernet runs it: the parameters cast to the input's dtype on
            # each call, the bias added to the conv's rounded output (a
            # second rounding, which torch's fused bias would not make)
            y = self._conv_forward(x, self.weight.to(x.dtype), None)
            if self.bias is not None:
                y = y + self.bias.to(x.dtype)[:, None, None]
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.BatchNorm2d):
    """BN over the last (channel) axis of an NHWC tensor, eps 1e-5, with the
    JAX package's (flax's) semantics in both modes.

    Eval: running statistics, folded to x * scale + bias in fp32.
    Train: batch mean and *biased* variance over N, H, W in fp32; the running
    statistics move by momentum 0.1 towards that mean and that biased
    variance (flax's `ra_var = 0.9 ra_var + 0.1 var`). `nn.BatchNorm2d`
    would use the unbiased variance there, which differs by n / (n - 1).
    The output is cast back to the input dtype in both modes. With `mesh`
    set (`parallel.sync_batchnorm_`) the train-mode statistics are the
    global batch's (`batch_moments`)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)
        self.mesh = None

    def folded(self):
        """(scale, bias) in float32 with BN(x) == x * scale + bias."""
        return fold_bn(self.weight.float(), self.bias.float(),
                       self.running_mean.float(), self.running_var.float(),
                       self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        scale, bias = self.folded()
        return (x.float() * scale + bias).to(x.dtype)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax's arithmetic, differentiated by autograd through the batch
        # statistics. (F.batch_norm's fused CPU backward loses accuracy where
        # a channel's batch variance is small: on a 64x128 batch of the
        # student its parameter gradients were 24 % off a float64 run where
        # this form's were 2 %, the JAX package's 7 %.)
        xf = upcast(x)
        mean, var, _ = batch_moments(xf, self.mesh)
        y = (xf - mean) * (self.weight * torch.rsqrt(var + self.eps)) \
            + self.bias
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


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
