"""Train-mode BatchNorm and the training init of fasterseg_tpu_torch
against the JAX package (flax 0.12 `nn.BatchNorm` through
fasterseg_tpu.ops.conv.BatchNorm), fp32.

On a (1, 2, 4, C) map a channel's statistics come from n = 8 values, so the
unbiased variance that `torch.nn.BatchNorm2d` would use differs from the
biased one flax uses by n / (n - 1) = 8 / 7: the tests would see it. Bars:
outputs and statistics to 1e-5 (rtol and atol), input gradients to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasterseg_tpu.ops.conv import KAIMING
from fasterseg_tpu.ops.conv import BatchNorm as JaxBatchNorm
from fasterseg_tpu_torch.models import DerivedNet, student_plan
from fasterseg_tpu_torch.ops.conv import BatchNorm, Conv
from fasterseg_tpu_torch.utils import init_training_


def _stats_pair(seed, shape=(1, 2, 4, 6), steps=3):
    """Port and flax BN, both from their init (scale 1, bias 0, mean 0,
    var 1) with the port's scale and bias set to flax's random ones, run
    `steps` train-mode batches; returns both outputs and statistics."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    gamma = (rng.random(c) + 0.5).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    jbn = JaxBatchNorm()
    xs = [(rng.standard_normal(shape) * 2 + 1).astype(np.float32)
          for _ in range(steps)]
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), True)
    params = {"bn": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}
    stats = variables["batch_stats"]
    bn = BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
    outs = []
    for x in xs:
        want, upd = jbn.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = bn(torch.from_numpy(x))
        outs.append((got.detach().numpy(), np.asarray(want)))
    return bn, stats, outs, xs


@pytest.mark.parametrize("seed", [0, 1])
def test_train_bn_matches_flax(seed):
    bn, stats, outs, _ = _stats_pair(seed)
    for got, want in outs:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["bn"]["mean"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["bn"]["var"]),
                               rtol=1e-5, atol=1e-5)
    assert int(bn.num_batches_tracked) == 3


def test_running_var_is_biased():
    """One step from var 1: 0.9 + 0.1 * biased var, not the unbiased
    n / (n - 1) = 8 / 7 times larger one torch's own BN would take."""
    bn, stats, _, xs = _stats_pair(2, steps=1)
    x = torch.from_numpy(xs[0]).reshape(-1, xs[0].shape[-1])
    biased = 0.9 + 0.1 * x.var(0, unbiased=False)
    unbiased = 0.9 + 0.1 * x.var(0, unbiased=True)
    torch.testing.assert_close(bn.running_var, biased, rtol=1e-6, atol=1e-6)
    assert (unbiased - biased).abs().min() > 1e-3
    ref = torch.nn.BatchNorm2d(x.shape[1]).train()
    ref(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    torch.testing.assert_close(ref.running_var, unbiased, rtol=1e-6,
                               atol=1e-6)


def test_train_bn_input_gradient_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    w = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    jbn = JaxBatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), True)

    def f(z):
        y, _ = jbn.apply(variables, z, True, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(w))
    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (BatchNorm(4).train()(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_train_bn_keeps_input_dtype():
    x = torch.randn(2, 3, 4, 8, generator=torch.Generator().manual_seed(0))
    bn = BatchNorm(8).train()
    y = bn(x.bfloat16())
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), bn(x.bfloat16().float()),
                               rtol=1e-2, atol=1e-2)


def test_training_init_statistics():
    """init_training_: every conv weight ~ N(0, 2 / fan_in), as the JAX
    package's KAIMING initializer draws it; conv biases 0; BN scale 1, bias
    0, running mean 0, var 1; a seed gives the same weights twice."""
    net = init_training_(DerivedNet(student_plan()), 0)
    shapes = 0
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            w = m.weight.detach()
            fan_in = w[0].numel()
            if w.numel() >= 20000:       # enough draws to read the spread
                shapes += 1
                assert abs(w.std().item() / (2.0 / fan_in) ** 0.5 - 1) < 0.03
                assert abs(w.mean().item()) < 0.03 * (2.0 / fan_in) ** 0.5
                hwio = tuple(w.permute(2, 3, 1, 0).shape)
                jw = np.asarray(KAIMING(jax.random.PRNGKey(0), hwio))
                assert abs(jw.std() / w.std().item() - 1) < 0.05
            if m.bias is not None:
                assert torch.all(m.bias == 0)
        elif isinstance(m, BatchNorm):
            assert torch.all(m.weight == 1) and torch.all(m.bias == 0)
            assert torch.all(m.running_mean == 0)
            assert torch.all(m.running_var == 1)
    assert shapes >= 5
    again = init_training_(DerivedNet(student_plan()), 0).state_dict()
    other = init_training_(DerivedNet(student_plan()), 1).state_dict()
    k = "stem.0.conv.0.weight"
    assert torch.equal(net.state_dict()[k], again[k])
    assert not torch.equal(net.state_dict()[k], other[k])
    assert any(isinstance(m, Conv) for m in net.heads32.modules())
