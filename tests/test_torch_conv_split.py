"""The fp32 conv route's split arithmetic, emulated in plain torch on the
CPU, against the JAX package's `conv3x3_bn_relu_reference` at the JAX
package's fp32 bars.

The card's fp32 route (csrc/conv3x3_bn_relu.cu, route 3) runs every 3x3
conv of an fp32 forward on the tensor cores as 3xTF32: each activation and
weight is split into hi = tf32(v) and lo = tf32(v - hi), and the products
hi*hi + lo*hi + hi*lo are summed in fp32 (lo*lo is dropped). The
alternative was split bf16 (the same three products of 8-bit halves, at
twice the rate), to be taken only if it stayed at least 4x under every bar
at the main path's channel counts. These tests hold each design against the
JAX reference on the draws of `chip_smoke._conv_inputs` (numpy seed), at
unit scale and at 8x (trained activations are not unit-variance), and
print the margin: the largest |got - ref| / (atol + rtol |ref|), 1 at the
bar.

JAX is the oracle only; torch runs on two threads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from fasterseg_tpu.pallas.conv import conv3x3_bn_relu_reference
from fasterseg_tpu_torch.kernels import (round_tf32, split_weights,
                                         unpack_weights)
from _torch_search_common import few_threads  # noqa: F401 (autouse)

# (Ci, Co, H, W): the main path's input channel counts (the stem entry, the
# stem's and cells' 32 and 64, the refine concat 64 + 32, the teacher's 192
# and 384) on small maps
CHANNELS = [(3, 32, 32, 64), (32, 64, 32, 64), (64, 64, 32, 64),
            (96, 64, 16, 32), (192, 192, 16, 32), (384, 384, 8, 16)]
SCALES = (1.0, 8.0)


def _bar(stride: int) -> float:
    """rtol = atol of the JAX package's fp32 conv tests
    (tests/test_pallas_conv.py:33,66)."""
    return 1e-4 if stride == 1 else 2e-4


def _round_bf16(t):
    return t.bfloat16().float()


def _round_tf32_independent(t):
    """Nearest value with a 10-bit mantissa, ties away from zero, computed
    in float64 from the exponent (not from the bits, as `round_tf32`)."""
    a = t.double()
    mag = a.abs()
    _, e = torch.frexp(mag)                 # mag = m * 2^e, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(mag), e - 11)
    r = torch.floor(mag / ulp + 0.5) * ulp
    return (torch.sign(a) * torch.where(mag > 0, r, mag)).float()


def _conv(x, w, stride):
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    stride=stride, padding=1).permute(0, 2, 3, 1)


def emulate(x, w, scale, bias, stride, design):
    """relu(conv3x3(x, w) * scale + bias) as `design` computes it: products
    of rounded halves, summed in fp32 (the tensor cores' accumulators).
    "tf32x3" / "bf16x3": hi*hi + lo*hi into one sum, hi*lo into another,
    then added, as the kernel does; "tf32x1" / "bf16x1": one pass of
    rounded operands."""
    rnd = _round_tf32_independent if design.startswith("tf32") \
        else _round_bf16
    xh, wh = rnd(x), rnd(w)
    if design.endswith("x1"):
        y = _conv(xh, wh, stride)
    else:
        xl, wl = rnd(x - xh), rnd(w - wh)
        y = (_conv(xh, wh, stride) + _conv(xl, wh, stride)) \
            + _conv(xh, wl, stride)
    return torch.relu(y * scale + bias)


def _margin(design, ci, co, h, w, stride, scale_x, seed=0):
    rng = np.random.default_rng(seed)
    x, wt, s, b = chip_smoke._conv_inputs(rng, h, w, ci, co, "cpu")
    x = x * scale_x
    ref = np.asarray(conv3x3_bn_relu_reference(
        *(jnp.asarray(t.numpy()) for t in (x, wt, s, b)), stride))
    got = emulate(x, wt, s, b, stride, design).numpy()
    bar = _bar(stride)
    return float((np.abs(got - ref) / (bar + bar * np.abs(ref))).max())


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("ci,co,h,w", CHANNELS)
def test_3xtf32_holds_the_fp32_bars(ci, co, h, w, stride):
    """The chosen design within the JAX bars at every main-path channel
    count, both strides, unit and 8x activations."""
    for scale_x in SCALES:
        m = _margin("tf32x3", ci, co, h, w, stride, scale_x)
        print(f"tf32x3 Ci={ci} Co={co} s{stride} x{scale_x:g}: "
              f"margin {m:.4f}")
        assert m <= 1.0, (ci, co, stride, scale_x, m)


def test_split_bf16_is_not_4x_under_the_bars():
    """Split bf16 keeps only ~2^-16 of each operand: it is not 4x under the
    bars at these channel counts (it misses them outright at 8x scale),
    which is why the route is 3xTF32."""
    margins = {(ci, stride, sx): _margin("bf16x3", ci, co, h, w, stride, sx)
               for ci, co, h, w in CHANNELS for stride in (1, 2)
               for sx in SCALES}
    print("bf16x3 margins:", {k: round(v, 3) for k, v in margins.items()})
    assert max(margins.values()) > 0.25
    assert max(m for (ci, s, sx), m in margins.items() if sx == 8.0) > 1.0


@pytest.mark.parametrize("design", ["bf16x1", "tf32x1"])
@pytest.mark.parametrize("ci", [64, 192, 384])
def test_single_pass_misses_the_bars(design, ci):
    """One pass of bf16 or TF32 operands misses the fp32 bars at Ci >= 64,
    so the bars tell a single-pass design from a split one."""
    co, h, w = next((co, h, w) for c, co, h, w in CHANNELS if c == ci)
    m = _margin(design, ci, co, h, w, 1, 1.0)
    print(f"{design} Ci={ci}: margin {m:.2f}")
    assert m > 1.0


def test_round_tf32_is_round_to_nearest_ties_away():
    """`round_tf32` (the host's rounding of the weights, PTX's cvt.rna of
    the activations) against the exponent-based rounding, on random values
    of many magnitudes, exact ties and values that carry into the next
    binade."""
    rng = np.random.default_rng(0)
    vals = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096))
    base = rng.integers(1, 2 ** 10, 64)
    ties = np.concatenate([((1024 + base) * 2 + 1) / 2 ** 11,
                           np.full(4, (2 ** 11 - 1) / 2 ** 11 + 2 ** -12)])
    t = torch.from_numpy(np.concatenate([vals, ties, -ties, [0.0]])
                         .astype(np.float32))
    assert torch.equal(round_tf32(t), _round_tf32_independent(t))
    # ties round away from zero
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)])
    assert torch.equal(round_tf32(tie), torch.tensor([1 + 2 ** -10,
                                                      -(1 + 2 ** -10)]))


def test_emulated_weights_are_the_packed_weights():
    """The emulation's weight halves are what `split_weights` packs for the
    fp32 route."""
    rng = np.random.default_rng(1)
    _, wt, _, _ = chip_smoke._conv_inputs(rng, 4, 4, 96, 64, "cpu")
    hi, lo = unpack_weights(split_weights(wt, (64, 32), torch.float32))
    wh = _round_tf32_independent(wt)
    assert torch.equal(hi, wh)
    assert torch.equal(lo, _round_tf32_independent(wt - wh))
