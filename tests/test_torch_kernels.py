"""fasterseg_tpu_torch kernel wrappers: the plain versions against the JAX
package's Pallas kernels (interpret mode on the CPU) and the wrappers' input
checks. The CUDA kernels are held against their plain versions on the card
in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasterseg_tpu.pallas.conv import (conv3x3_bn_relu_planar,
                                       conv3x3s2_bn_relu_s2d, fold_bn,
                                       nhwc_to_planar, planar_to_nhwc,
                                       space_to_depth_planar)
from fasterseg_tpu.models.fast_body import _w3_concat
from fasterseg_tpu.pallas.conv import conv3x3_bn_relu_reference
from fasterseg_tpu.pallas.fused import upsample8_argmax as j_upsample8_argmax
from fasterseg_tpu.pallas.fused import upsample8_argmax_xla
from fasterseg_tpu_torch import kernels
from fasterseg_tpu_torch.kernels import (conv3x3_bn_relu,
                                         conv3x3_bn_relu_plain, input_parts,
                                         round_tf32, split_weights,
                                         unpack_weights,
                                         upsample8_argmax,
                                         upsample8_argmax_plain)
from fasterseg_tpu_torch.kernels import fused
from fasterseg_tpu_torch.kernels.resize import (resize_bilinear,
                                                resize_bilinear_plain, taps)
from fasterseg_tpu_torch.ops.resize import in_float64, interp_matrix
from fasterseg_tpu_torch.ops.resize import resize_bilinear as contraction
from _torch_resize_cases import (EDGE_RESIZES, SERVING_RESIZES, TAP_SIZES,
                                ulps)
from _torch_upsample_cases import UPSAMPLE_SHAPES, upsample_inputs


def _conv_inputs(rng, H, W, ci, co):
    x = rng.standard_normal((1, H, W, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32)
    scale = (rng.random(co) + 0.5).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.1).astype(np.float32)
    return x, w, scale, bias


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("H,W,ci,co,stride", [
    (32, 64, 3, 32, 2),
    (32, 64, 32, 64, 2),
    (16, 32, 64, 64, 1),
    (16, 32, 16, 48, 1),
])
def test_conv_plain_matches_planar_kernel(rng, H, W, ci, co, stride):
    x, w, s, b = _conv_inputs(rng, H, W, ci, co)
    want = planar_to_nhwc(conv3x3_bn_relu_planar(
        nhwc_to_planar(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(s),
        jnp.asarray(b), stride), co)
    got = conv3x3_bn_relu(*_t(x, w, s, b), stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("H,W,ci,co,relu", [
    (32, 64, 3, 32, True),
    (16, 32, 8, 16, True),
    (16, 32, 32, 64, False),
])
def test_conv_plain_matches_s2d_kernel(H, W, ci, co, relu):
    rng = np.random.default_rng(0)
    x, w, s, b = _conv_inputs(rng, H, W, ci, co)
    got_p = conv3x3s2_bn_relu_s2d(
        space_to_depth_planar(jnp.asarray(x), ci), jnp.asarray(w),
        jnp.asarray(s), jnp.asarray(b), relu=relu, interpret=True)
    want = np.asarray(jnp.transpose(got_p[:, :co], (0, 2, 1))[None])
    got = conv3x3_bn_relu_plain(*_t(x, w, s, b), stride=2, relu=relu)
    assert tuple(got.shape) == (1, H // 2, W // 2, co)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_fold_bn_matches_jax(rng):
    g, beta, m = (rng.standard_normal(8).astype(np.float32) for _ in range(3))
    v = rng.random(8).astype(np.float32) + 0.5
    want = fold_bn(*(jnp.asarray(a) for a in (g, beta, m, v)))
    got = kernels.fold_bn(*_t(g, beta, m, v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_upsample8_argmax_plain_matches_pallas(rng):
    p8 = rng.standard_normal((1, 16, 32, 19), dtype=np.float32)
    want = np.asarray(j_upsample8_argmax(jnp.asarray(p8), tile_h=32))
    got = upsample8_argmax(torch.from_numpy(p8)).numpy()
    assert got.shape == want.shape == (1, 128, 256)
    assert got.dtype == np.int32
    # the Pallas kernel rounds its interpolation to bf16 (fused.py:53,77-78)
    # and the port does not, so exact near-ties may flip
    assert (got != want).mean() < 0.005


def test_upsample8_argmax_plain_onehot_exact(rng):
    lbl = rng.integers(0, 19, (1, 16, 32))
    p8 = np.full((1, 16, 32, 19), -5.0, np.float32)
    np.put_along_axis(p8, lbl[..., None], 5.0, axis=-1)
    want = np.asarray(j_upsample8_argmax(jnp.asarray(p8), tile_h=32))
    got = upsample8_argmax_plain(torch.from_numpy(p8))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h8,w8,c,out_hw", UPSAMPLE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample8_argmax_plain_matches_xla_contract(rng, h8, w8, c, out_hw,
                                                     dtype):
    """The plain version against the JAX package's contract
    `upsample8_argmax_xla` (pallas/fused.py:101) over the shapes the CUDA
    kernel is held to on the card: exact on one-hot logits, the Pallas
    kernel's 99.5 % (tests/test_pallas.py:17) on random ones."""
    for kind, p8 in zip(("onehot", "random"), upsample_inputs(rng, h8, w8, c)):
        pt = torch.from_numpy(p8).to(getattr(torch, dtype))
        pj = jnp.asarray(p8).astype(dtype)
        want = np.asarray(upsample8_argmax_xla(pj, out_hw))
        got = upsample8_argmax_plain(pt, out_hw).numpy()
        assert got.dtype == np.int32 and got.shape == want.shape
        if kind == "onehot":
            np.testing.assert_array_equal(got, want)
        else:
            assert (got == want).mean() >= 0.995


@pytest.mark.parametrize("h8,w8,c,out_hw", UPSAMPLE_SHAPES + [
    (128, 256, 19, None), (128, 256, 19, (1000, 2047))])
def test_upsample_tile_plan_covers_every_tile(h8, w8, c, out_hw):
    """The tile kernel's host-side plan: every tile's source rows and the
    three source columns of every four-column group lie inside the
    footprint, whose shared memory fits; else the pixel kernel is taken."""
    H, W = out_hw or (8 * h8, 8 * w8)
    fr, fc, cp = fused._plan(h8, w8, c, H, W)
    th, tw = fused._TILE_H, fused._TILE_W
    ylo, yhi, ty = fused._padded_coords(h8, H, th)
    xlo, xhi, tx = fused._padded_coords(w8, W, tw)
    assert len(ylo) % th == 0 and len(xlo) % tw == 0
    # the padding repeats the last entry of ops.resize._ac_coords
    from fasterseg_tpu_torch.ops.resize import _ac_coords
    for padded, plain in zip((xlo, xhi, tx), _ac_coords(w8, W)):
        np.testing.assert_array_equal(padded[:W], plain)
        assert (padded[W:] == plain[-1]).all()
    if fr == 0:
        # the pixel kernel: small factors, downsamples, more than 24 channels
        assert max((h8 - 1) / max(H - 1, 1), (w8 - 1) / max(W - 1, 1)) > 0.3 \
            or c > 24
        return
    assert c <= 24 and cp >= c and cp % 8 == 4
    assert ((fr + fused._WARPS) * fc * cp + 3 * th) * 4 <= 48 * 1024
    for r0 in range(0, len(ylo), th):
        rows = slice(r0, r0 + th)
        assert ylo[rows].min() == ylo[r0] and yhi[rows].max() - ylo[r0] < fr
    for c0 in range(0, len(xlo), tw):
        for g in range(c0, c0 + tw, 4):
            group = xlo[g:g + 4] - xlo[g]
            assert set(group.tolist()) <= {0, 1}
            assert xhi[g + 3] <= xlo[g] + 2      # three columns reach the pair
            assert 0 <= xlo[g] - xlo[c0] and xlo[g] - xlo[c0] + 2 < fc


def test_upsample8_argmax_out_hw_and_first_max():
    p8 = torch.zeros((1, 4, 6, 5))
    p8[..., 2] = 1.0
    p8[..., 4] = 1.0   # tie with channel 2: the first maximum wins
    got = upsample8_argmax(p8, out_hw=(16, 24))
    assert tuple(got.shape) == (1, 16, 24)
    assert bool((got == 2).all())


@pytest.mark.parametrize("bad", ["dtype", "w_dtype", "w_shape", "x_rank",
                                 "batch", "scale", "stride"])
def test_conv_wrapper_rejects_bad_input(rng, bad):
    x, w, s, b = _t(*_conv_inputs(rng, 8, 8, 4, 8))
    kwargs = {"stride": 1}
    if bad == "dtype":
        x = x.half()
    elif bad == "w_dtype":
        w = w.bfloat16()
    elif bad == "w_shape":
        w = w[:, :, :3]
    elif bad == "x_rank":
        x = x[0]
    elif bad == "batch":
        x = torch.cat([x, x])
    elif bad == "scale":
        s = s[:4]
    else:
        kwargs["stride"] = 3
    with pytest.raises((TypeError, ValueError)):
        conv3x3_bn_relu(x, w, s, b, **kwargs)


# one input and two; chunks of 64 and of 32 channels, parts that are not
# whole chunks (48, 16), blocks of 32 and 64 output channels, padded (19, 48)
# and several (96, 192) blocks
@pytest.mark.parametrize("ci_parts,co", [
    ((64,), 64), ((32,), 32), ((48,), 19), ((16,), 48), ((64, 32), 64),
    ((128, 64), 96), ((96, 96), 192), ((3,), 32)])
def test_split_weights_round_trip(rng, ci_parts, co):
    w = torch.from_numpy(rng.standard_normal(
        (3, 3, sum(ci_parts), co)).astype(np.float32))
    cw = split_weights(w, ci_parts if len(ci_parts) > 1 else None)
    assert cw.ci_parts == ci_parts and cw.packed.dtype == torch.bfloat16
    assert cw.ck == (64 if all(c % 64 == 0 for c in ci_parts) else 32)
    assert cw.bn == (32 if co <= 32 else 64)
    chunks = sum(-(-c // cw.ck) for c in ci_parts)
    assert tuple(cw.packed.shape) == (-(-co // cw.bn), chunks, 9, 2, cw.bn,
                                      cw.ck)
    hi, lo = unpack_weights(cw)
    # the packed layout round-trips to HWIO, bit for bit
    assert torch.equal(hi, w.bfloat16().float())
    assert torch.equal(lo, (w - w.bfloat16().float()).bfloat16().float())
    # hi + lo keeps w to 2^-15 relative (two bf16 mantissas)
    assert ((hi + lo - w).abs() <= w.abs() * 2.0 ** -15).all()
    assert torch.equal(cw.w, w)


def test_split_weights_layout_is_the_swizzled_operand(rng):
    """Element (n, k) of a (tap, chunk) slab lies where the tensor cores'
    128-byte (ck = 64) or 64-byte (ck = 32) swizzle puts it: byte offset
    n * ck * 2 + k * 2 with address bits [4, 7) ^= bits [7, 10)."""
    for ci, mask in ((64, 7), (32, 3)):
        w = torch.from_numpy(rng.standard_normal((3, 3, ci, 64))
                             .astype(np.float32))
        cw = split_weights(w)
        hi = w.bfloat16()
        slab = cw.packed[0, 0, 5, 0].reshape(-1)     # tap (1, 2), hi
        for n in (0, 1, 5, 9, 63):
            for k in (0, 7, 8, 31, ci - 1):
                off = n * ci * 2 + k * 2
                off ^= ((off >> 7) & mask) << 4
                assert slab[off // 2] == hi[1, 2, k, n], (ci, n, k)


# the fp32 route's packing: chunks of 32 and of 16 fp32 channels (128 and 64
# bytes a pixel), parts that are not whole chunks (48, 16), padded and
# several output blocks
@pytest.mark.parametrize("ci_parts,co", [
    ((64,), 64), ((32,), 32), ((48,), 19), ((16,), 48), ((64, 32), 64),
    ((128, 64), 96), ((96, 96), 192), ((3,), 32)])
def test_split_weights_fp32_round_trip(rng, ci_parts, co):
    w = torch.from_numpy(rng.standard_normal(
        (3, 3, sum(ci_parts), co)).astype(np.float32))
    cw = split_weights(w, ci_parts if len(ci_parts) > 1 else None,
                       torch.float32)
    assert cw.packed.dtype == torch.float32 and cw.dtype == torch.float32
    assert cw.ck == (32 if all(c % 32 == 0 for c in ci_parts) else 16)
    assert cw.bn == (32 if co <= 32 else 64)
    chunks = sum(-(-c // cw.ck) for c in ci_parts)
    assert tuple(cw.packed.shape) == (-(-co // cw.bn), chunks, 9, 2, cw.bn,
                                      cw.ck)
    hi, lo = unpack_weights(cw)
    assert torch.equal(hi, round_tf32(w))
    assert torch.equal(lo, round_tf32(w - hi))
    # both halves are TF32 values (the low 13 bits zero), and hi + lo keeps
    # w to 2^-21 relative (two 11-bit significands)
    for half in (hi, lo):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - w).abs() <= w.abs() * 2.0 ** -21).all()
    assert torch.equal(cw.w, w)


def test_split_weights_fp32_layout_is_the_swizzled_operand(rng):
    """fp32 packing: element (n, k) of a (tap, chunk) slab lies at byte
    offset n * ck * 4 + k * 4 with the 128-byte (ck = 32) or 64-byte
    (ck = 16) swizzle, address bits [4, 7) ^= bits [7, 10)."""
    for ci, mask in ((64, 7), (16, 3)):
        w = torch.from_numpy(rng.standard_normal((3, 3, ci, 64))
                             .astype(np.float32))
        cw = split_weights(w, dtype=torch.float32)
        ck = cw.ck
        hi = round_tf32(w)
        for chunk in range(ci // ck):
            slab = cw.packed[0, chunk, 5, 0].reshape(-1)  # tap (1, 2), hi
            for n in (0, 1, 5, 9, 63):
                for k in (0, 3, 4, 7, ck - 1):
                    off = n * ck * 4 + k * 4
                    off ^= ((off >> 7) & mask) << 4
                    assert slab[off // 4] == hi[1, 2, chunk * ck + k, n]


def test_split_weights_rejects_bad_input(rng):
    w = torch.zeros((3, 3, 8, 4))
    with pytest.raises(ValueError):
        split_weights(w, (4, 3))
    with pytest.raises(ValueError):
        split_weights(w.bfloat16())
    with pytest.raises(ValueError):
        split_weights(w[0])
    with pytest.raises(ValueError):
        split_weights(w, dtype=torch.float16)


@pytest.mark.parametrize("c1,c2,co,dtype", [
    (24, 8, 16, torch.float32), (64, 32, 64, torch.float32),
    (16, 16, 8, torch.bfloat16)])
def test_conv_two_inputs_plain_equals_concat(rng, c1, c2, co, dtype):
    x, w, s, b = _t(*_conv_inputs(rng, 12, 20, c1 + c2, co))
    x = x.to(dtype)
    a, c = x[..., :c1].contiguous(), x[..., c1:].contiguous()
    want = conv3x3_bn_relu_plain(x, w, s, b)
    assert torch.equal(conv3x3_bn_relu_plain(a, w, s, b, x2=c), want)
    # the wrapper on CPU tensors, with plain and with prepared weights
    assert torch.equal(conv3x3_bn_relu(a, w, s, b, x2=c), want)
    assert torch.equal(conv3x3_bn_relu(
        a, split_weights(w, input_parts(c1, c2), dtype), s, b, x2=c), want)


def test_input_parts_read_in_place_only_at_multiples_of_16():
    assert input_parts(64) == (64,)
    assert input_parts(64, 32) == (64, 32)
    assert input_parts(24, 8) == (32,)
    assert input_parts(16, 20) == (36,)


@pytest.mark.parametrize("packed_for", ["bf16", "one input", "two inputs"])
def test_conv_rejects_weights_packed_for_other_inputs(rng, packed_for):
    """Weights packed for another dtype or other inputs raise, on the CPU
    as on the card, rather than being packed again on every call."""
    x, w, s, b = _t(*_conv_inputs(rng, 8, 12, 96, 16))
    a, c = x[..., :64].contiguous(), x[..., 64:].contiguous()
    cw = {"bf16": split_weights(w, dtype=torch.bfloat16),
          "one input": split_weights(w, dtype=torch.float32),
          "two inputs": split_weights(w, (64, 32), torch.float32)}[packed_for]
    with pytest.raises(ValueError, match="packed for"):
        if packed_for == "one input":
            conv3x3_bn_relu(a, cw, s, b, x2=c)
        else:
            conv3x3_bn_relu(x, cw, s, b)


@pytest.mark.parametrize("c1,c2,co", [(24, 8, 16), (64, 32, 64)])
def test_conv_two_inputs_matches_jax_refine(rng, c1, c2, co):
    """The JAX package's refine conv never builds the concat either: it
    concatenates the parts' padded planar blocks and scatters the weight's
    input-channel segments to match (models/fast_body.py `_refine_3x3`)."""
    x, w, s, b = _conv_inputs(rng, 16, 32, c1 + c2, co)
    parts = [nhwc_to_planar(jnp.asarray(x[..., :c1])),
             nhwc_to_planar(jnp.asarray(x[..., c1:]))]
    cps = [p.shape[1] for p in parts]
    wj = _w3_concat(jnp.asarray(w), cps, [c1, c2])
    want = planar_to_nhwc(conv3x3_bn_relu_planar(
        jnp.concatenate(parts, axis=1), wj, jnp.asarray(s), jnp.asarray(b)),
        co)
    xt, wt, st, bt = _t(x, w, s, b)
    got = conv3x3_bn_relu(xt[..., :c1].contiguous(), wt, st, bt,
                          x2=xt[..., c1:].contiguous())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    ref = conv3x3_bn_relu_reference(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(s), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "device", "height", "width",
                                 "rank", "channels", "stride"])
def test_conv_wrapper_rejects_bad_second_input(rng, bad):
    x, w, s, b = _t(*_conv_inputs(rng, 8, 8, 24, 8))
    a, c = x[..., :16].contiguous(), x[..., 16:].contiguous()
    kwargs = {}
    if bad == "dtype":
        c = c.bfloat16()
    elif bad == "device":
        c = c.to("meta")
    elif bad == "height":
        c = c[:, :4]
    elif bad == "width":
        c = c[:, :, :4]
    elif bad == "rank":
        c = c[0]
    elif bad == "channels":
        c = c[..., :4]       # w no longer matches 16 + 4 input channels
    else:
        kwargs["stride"] = 2
    with pytest.raises((TypeError, ValueError)):
        conv3x3_bn_relu(a, w, s, b, x2=c, **kwargs)


@pytest.mark.parametrize("p8", [torch.zeros((1, 4, 4, 3), dtype=torch.int32),
                                torch.zeros((4, 4, 3)),
                                torch.zeros((2, 4, 4, 3))])
def test_upsample_wrapper_rejects_bad_input(p8):
    with pytest.raises((TypeError, ValueError)):
        upsample8_argmax(p8)


@pytest.mark.parametrize("out_hw", [(0, 8), (8, 0), (70000, 8)])
def test_upsample_wrapper_rejects_bad_out_hw(out_hw):
    with pytest.raises(ValueError, match="out_hw"):
        upsample8_argmax(torch.zeros((1, 2, 2, 3)), out_hw)


def test_cpu_wrappers_launch_nothing(rng):
    kernels.reset_launch_counts()
    x, w, s, b = _t(*_conv_inputs(rng, 8, 8, 4, 8))
    conv3x3_bn_relu(x, w, s, b, stride=2)
    upsample8_argmax(torch.zeros((1, 2, 2, 3)))
    resize_bilinear(x, (4, 16), relu=True)
    assert "resize_bilinear" in kernels.launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    assert set(kernels.route_launch_counts().values()) == {0}


# ---- the resize kernel's plain version (kernels/resize.py) ----


@pytest.mark.parametrize("in_size,out_size", TAP_SIZES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resize_taps_are_the_matrix_nonzeros(in_size, out_size, dtype):
    """Put back where they came from, the taps are the contraction's matrix
    in `dtype`, every row's nonzeros at lo and hi (the edge row's single 1
    at lo); an axis that keeps its size is the identity."""
    lo, hi, w_lo, w_hi = taps(in_size, out_size, dtype)
    rows = np.arange(out_size)
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (rows, lo), w_lo)
    np.add.at(m, (rows, hi), w_hi)
    if in_size == out_size:
        want = np.eye(in_size, dtype=np.float32)
    else:
        want = interp_matrix(in_size, out_size, dtype,
                             torch.device("cpu")).float().numpy()
    np.testing.assert_array_equal(m, want)
    assert ((0 <= lo) & (lo <= hi) & (hi <= lo + 1) & (hi < in_size)).all()
    assert (w_hi[hi == lo] == 0).all()
    if in_size != out_size:
        # the corners are aligned: the first output reads the first source
        # row alone, the last output reaches the last source row
        assert lo[0] == 0 and w_lo[0] == 1
        assert out_size == 1 or hi[-1] == in_size - 1


def _contraction(x: torch.Tensor, out_hw, relu: bool) -> torch.Tensor:
    """The serving path's resize before the kernel: the matrix contractions
    of ops/resize.py, fp32 maps in float64, then torch.relu."""
    y = in_float64(contraction, x, out_hw)
    return torch.relu(y) if relu else y


@pytest.mark.parametrize("shape,out_hw,relu", SERVING_RESIZES + EDGE_RESIZES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resize_plain_matches_contraction(rng, shape, out_hw, relu, dtype):
    """Within one ulp of the contraction everywhere and bit for bit on at
    least 99.99 % of the elements."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = x.to(dtype)
    got = resize_bilinear_plain(x, out_hw, relu)
    want = _contraction(x, out_hw, relu)
    assert got.dtype == dtype and got.shape == want.shape
    apart = ulps(got, want)
    assert int(apart.max()) <= 1
    assert (apart == 0).float().mean().item() >= 0.9999
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(resize_bilinear(x, out_hw, relu), got)


@pytest.mark.parametrize("shape,out_hw", [
    ((1, 8, 16, 64), (16, 32)), ((1, 16, 32, 32), (32, 64)),
    ((2, 7, 9, 19), (13, 4)), ((1, 32, 64, 19), (256, 512))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resize_fused_relu_is_relu_after(rng, shape, out_hw, dtype):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = x.to(dtype)
    got = resize_bilinear(x, out_hw, relu=True)
    assert torch.equal(got, torch.relu(resize_bilinear(x, out_hw)))
    assert bool((got >= 0).all()) and bool((got == 0).any())


def _misaligned(shape):
    flat = torch.zeros(int(np.prod(shape)) + 1)
    return flat[1:].view(shape)


@pytest.mark.parametrize("bad", ["int", "half", "rank", "permuted",
                                 "misaligned", "zero_out", "tall_out"])
def test_resize_wrapper_rejects_bad_input(bad):
    x, out_hw = torch.zeros((1, 4, 6, 8)), (8, 12)
    if bad == "int":
        x = x.int()
    elif bad == "half":
        x = x.half()
    elif bad == "rank":
        x = x[0]
    elif bad == "permuted":
        x = torch.zeros((1, 8, 4, 6)).permute(0, 2, 3, 1)
    elif bad == "misaligned":
        x = _misaligned((1, 4, 6, 8))
        assert x.is_contiguous()
    elif bad == "zero_out":
        out_hw = (0, 12)
    else:
        out_hw = (70000, 12)
    with pytest.raises((TypeError, ValueError)):
        resize_bilinear(x, out_hw)
    with pytest.raises((TypeError, ValueError)):
        resize_bilinear_plain(x, out_hw)


def test_serving_resizes_take_the_wrapper(monkeypatch):
    """A student class map resizes 25 times, each through
    `kernels.resize_bilinear` (10 with the zoomed stride-1 cell's ReLU
    fused), and counts no contraction."""
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            fast_body, student_plan)
    from fasterseg_tpu_torch.utils import init_random_, profiling
    calls = []

    def spy(x, out_hw, relu=False):
        calls.append(relu)
        return resize_bilinear(x, out_hw, relu)

    monkeypatch.setattr(fast_body, "resize_bilinear", spy)
    plan = student_plan()
    runner = InferenceRunner(plan, init_random_(DerivedNet(plan), 0),
                             device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 64, 128, 3)).astype(np.float32))
    profiling.reset()
    with profiling.recording():
        runner.classmap(x)
    counters = profiling.summary()["counters"]
    profiling.reset()
    assert len(calls) == 25 and sum(calls) == 10
    assert "resize.contraction" not in counters
