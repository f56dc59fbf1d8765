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
from fasterseg_tpu.pallas.fused import upsample8_argmax as j_upsample8_argmax
from fasterseg_tpu_torch import kernels
from fasterseg_tpu_torch.kernels import (conv3x3_bn_relu,
                                         conv3x3_bn_relu_plain,
                                         upsample8_argmax,
                                         upsample8_argmax_plain)


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
    assert set(kernels.launch_counts().values()) == {0}
