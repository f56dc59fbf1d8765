"""The plain FasterSeg network: its parameters by name, and its forward.

A frozen copy of the published equations (FasterSeg train/model_seg.py
`Network_Multi_Path_Infer`, search/operations.py, search/seg_oprs.py) as
functions of a dict of tensors, in NCHW. Parameter names are the published
checkpoint's (`stem.0.conv.0.weight`, `cells.3-0._op._op.conv1.weight`,
`heads8.conv_3x3.bn.running_var`, ...). Every 3x3 conv pads 1, every 1x1
conv pads 0; resizes are align-corners bilinear (`F.interpolate`); eval BN
is folded here into a scale and a bias; train BN normalises by the batch
mean and biased variance.

`precision` says how the convs compute: "fp32" (cuDNN's and cuBLAS's TF32
off), "tf32" (inputs and weights rounded to TF32's 10-bit mantissa, to
nearest, products summed in fp32; on the card cuDNN's TF32 is on as well,
so the backward computes in TF32 too) or "fp8" (inputs and weights rounded
to float8 e4m3 under a per-tensor scale, products summed in fp32). Only
"fp32" is the reference; the others are the controls that the correctness
limits are held against. The forward's rounding is written out, so a
control computes it the same on the CPU as on the card; gradients pass
the rounding unchanged.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from .plan import Plan, num_filters, stem_channels

EPS = 1e-5
FP8_MAX = 448.0

# ---- parameter list ----


def _conv(name: str, c_in: int, c_out: int, k: int, bias: bool = False):
    out = [(f"{name}.weight", (c_out, c_in, k, k), "conv")]
    if bias:
        out.append((f"{name}.bias", (c_out,), "conv_bias"))
    return out


def _bn(name: str, c: int):
    return [(f"{name}.weight", (c,), "bn_weight"),
            (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "bn_mean"),
            (f"{name}.running_var", (c,), "bn_var"),
            (f"{name}.num_batches_tracked", (), "bn_count")]


def _convnorm(name: str, c_in: int, c_out: int, k: int):
    return _conv(f"{name}.conv.0", c_in, c_out, k) + _bn(f"{name}.conv.1", c_out)


def _convbnrelu(name: str, c_in: int, c_out: int, k: int):
    return _conv(f"{name}.conv", c_in, c_out, k) + _bn(f"{name}.bn", c_out)


def _head(name: str, c_in: int, classes: int):
    mid = c_in if c_in <= 256 else c_in // 2
    return (_convbnrelu(f"{name}.conv_3x3", c_in, mid, 3)
            + _conv(f"{name}.conv_1x1", mid, classes, 1, bias=True))


def _op(name: str, op: int, c_in: int, c_out: int, stride: int):
    if op == 0:
        if stride == 1:
            return []
        return (_conv(f"{name}.conv1", c_in, c_out // 2, 1)
                + _conv(f"{name}.conv2", c_in, c_out // 2, 1)
                + _bn(f"{name}.bn", c_out))
    out = _conv(f"{name}.conv1", c_in, c_out, 3) + _bn(f"{name}.bn1", c_out)
    if op in (3, 4):
        out += _conv(f"{name}.conv2", c_out, c_out, 3) + _bn(f"{name}.bn2", c_out)
    return out


def _features(plan: Plan):
    """Channel counts at 1/8, 1/16, 1/32 per branch after the cells."""
    c0 = stem_channels(plan)[2]
    ch = {8: [c0] * len(plan.lasts), 16: [c0] * len(plan.lasts),
          32: [c0] * len(plan.lasts)}
    for layer, groups in enumerate(plan.groups):
        for g in groups:
            c = plan.cell(layer, g[0])
            for b in g:
                ch[c.scale * (2 if c.down else 1)][b] = c.c_out
    return ch


def param_specs(plan: Plan) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and buffer of the network,
    kind one of conv, conv_bias, bn_weight, bn_bias, bn_mean, bn_var,
    bn_count."""
    s1, s2, s3 = stem_channels(plan)
    specs = _convnorm("stem.0", 3, s1, 3)
    for i, (a, b) in ((1, (s1, s2)), (2, (s2, s3))):
        specs += _op(f"stem.{i}", 3, a, b, 2)
    for c in plan.cells:
        specs += _op(f"cells.{c.layer}-{c.branch}._op._op", c.op, c.c_in,
                     c.c_out, 2 if c.down else 1)
    hw = plan.head_width
    nf = lambda s: num_filters(s, plan.fch, hw)
    ch = _features(plan)
    p8, p16, p32 = [], [], []
    for b, last in enumerate(plan.lasts):
        if last >= 1:
            p16.append(ch[16][b])
        if last == 2:
            p32.append(ch[32][b])
            specs += (_convnorm("arms32.0", ch[32][b], nf(16), 1)
                      + _convnorm("arms32.1", nf(16), nf(8), 1)
                      + _convnorm("refines32.0", nf(16) + ch[16][b], nf(16), 3)
                      + _convnorm("refines32.1", nf(8) + ch[8][b], nf(8), 3))
            p8.append(nf(8))
        elif last == 1:
            specs += (_convnorm("arms16", ch[16][b], nf(8), 1)
                      + _convnorm("refines16", nf(8) + ch[8][b], nf(8), 3))
            p8.append(nf(8))
        else:
            p8.append(ch[8][b])
    specs += _convbnrelu("ffm.conv_1x1", sum(p8), plan.ffm_channels, 1)
    specs += _head("heads8", plan.ffm_channels, plan.num_classes)
    if p16:
        specs += _head("heads16", sum(p16), plan.num_classes)
    if p32:
        specs += _head("heads32", sum(p32), plan.num_classes)
    return specs


# ---- precision of the convs ----


@contextlib.contextmanager
def precision_flags(precision: str) -> Iterator[None]:
    """cuDNN's and cuBLAS's TF32 switches on for "tf32" and off otherwise,
    and cuDNN's autotuning off; restored on exit."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.benchmark) = old


def _rounded(t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """t's values replaced by r's, its gradient passed as it is."""
    return t + (r - t).detach()


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10 mantissa bits), to nearest."""
    bits = t.detach().float().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(t.dtype)
    return _rounded(t, r)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    d = t.detach()
    scale = d.abs().amax().clamp(min=1e-30) / FP8_MAX
    return _rounded(t, (d / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale)


class Net:
    """The network of `plan` over the parameters `p` (name -> tensor)."""

    def __init__(self, plan: Plan, p: Dict[str, torch.Tensor],
                 precision: str = "fp32", train: bool = False):
        self.plan, self.p, self.precision, self.train = plan, p, precision, train

    # -- primitives --

    def conv(self, x, name, stride=1):
        w = self.p[f"{name}.weight"]
        k = w.shape[-1]
        b = self.p.get(f"{name}.bias")
        pad = 1 if k == 3 else 0
        if self.precision in ("fp8", "tf32"):
            q = _fp8 if self.precision == "fp8" else _tf32
            y = F.conv2d(q(x), q(w), None, stride, pad)
        else:
            y = F.conv2d(x, w, None, stride, pad)
        return y if b is None else y + b[:, None, None]

    def bn(self, x, name):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        if self.train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            scale = w * torch.rsqrt(var + EPS)
            return (x - mean[:, None, None]) * scale[:, None, None] \
                + b[:, None, None]
        scale = w * torch.rsqrt(self.p[f"{name}.running_var"] + EPS)
        bias = b - self.p[f"{name}.running_mean"] * scale
        return x * scale[:, None, None] + bias[:, None, None]

    def convnorm(self, x, name, stride=1):
        return F.relu(self.bn(self.conv(x, f"{name}.conv.0", stride),
                              f"{name}.conv.1"))

    def convbnrelu(self, x, name):
        return F.relu(self.bn(self.conv(x, f"{name}.conv"), f"{name}.bn"))

    def head(self, x, name):
        return self.conv(self.convbnrelu(x, f"{name}.conv_3x3"),
                         f"{name}.conv_1x1")

    def op(self, x, name, op, stride):
        h, w = x.shape[-2:]
        if op == 0:
            if stride == 1:
                return x
            y = torch.cat([self.conv(x, f"{name}.conv1", 2),
                           self.conv(x[:, :, 1:, 1:], f"{name}.conv2", 2)], 1)
            return F.relu(self.bn(y, f"{name}.bn"))
        zoomed = op in (2, 4)
        if zoomed:
            x = resize(x, (h // 2, w // 2))
        y = self.bn(self.conv(x, f"{name}.conv1", 1 if zoomed else stride),
                    f"{name}.bn1")
        if op in (3, 4):
            y = self.bn(self.conv(F.relu(y), f"{name}.conv2"), f"{name}.bn2")
        if zoomed and stride == 1:
            y = resize(y, (h, w))
        return F.relu(y)

    # -- the network --

    def forward(self, x):
        """x (N, 3, H, W) normalised. Eval: logits (N, classes, H/8, W/8).
        Train: (p8, p16, p32) at (H, W), p16 / p32 None where the plan
        has no such head."""
        plan = self.plan
        y = self.convnorm(x, "stem.0", 2)
        y = self.op(y, "stem.1", 3, 2)
        y = self.op(y, "stem.2", 3, 2)
        nb = len(plan.lasts)
        out = [y] * nb
        at = {8: [y] * nb, 16: [y] * nb, 32: [y] * nb}
        for layer, groups in enumerate(plan.groups):
            for g in groups:
                c = plan.cell(layer, g[0])
                o = self.op(out[g[0]], f"cells.{layer}-{g[0]}._op._op", c.op,
                            2 if c.down else 1)
                for b in g:
                    out[b] = o
                    at[c.scale * (2 if c.down else 1)][b] = o
        p8, p16, p32 = [], [], []
        for b, last in enumerate(plan.lasts):
            o8 = at[8][b]
            if last >= 1:
                p16.append(at[16][b])
            if last == 2:
                p32.append(at[32][b])
                o16 = at[16][b]
                t = self.convnorm(at[32][b], "arms32.0")
                t = resize(t, o16.shape[-2:])
                t = self.convnorm(torch.cat([t, o16], 1), "refines32.0")
                t = self.convnorm(t, "arms32.1")
                t = resize(t, o8.shape[-2:])
                p8.append(self.convnorm(torch.cat([t, o8], 1), "refines32.1"))
            elif last == 1:
                t = resize(self.convnorm(at[16][b], "arms16"), o8.shape[-2:])
                p8.append(self.convnorm(torch.cat([t, o8], 1), "refines16"))
            else:
                p8.append(o8)
        logits8 = self.head(self.convbnrelu(torch.cat(p8, 1), "ffm.conv_1x1"),
                            "heads8")
        if not self.train:
            return logits8
        hw = x.shape[-2:]
        up = lambda t: resize(upcast(t), hw)
        a16 = up(self.head(torch.cat(p16, 1), "heads16")) if p16 else None
        a32 = up(self.head(torch.cat(p32, 1), "heads32")) if p32 else None
        return up(logits8), a16, a32


def upcast(t: torch.Tensor) -> torch.Tensor:
    """fp32, or float64 where the network runs in float64."""
    return t if t.dtype == torch.float64 else t.float()


def resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Align-corners bilinear resize of an NCHW tensor to `hw`."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(int(v) for v in hw), mode="bilinear",
                         align_corners=True)


def logits(plan: Plan, p: Dict[str, torch.Tensor], x: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """Eval-mode full-resolution logits (N, classes, H, W) of NCHW images
    x, in fp32: the 1/8 logits upsampled x8."""
    with torch.no_grad(), precision_flags(precision):
        l8 = Net(plan, p, precision).forward(x)
        return resize(upcast(l8), x.shape[-2:])
