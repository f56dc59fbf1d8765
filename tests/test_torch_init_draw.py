"""The port's training init draws the JAX package's initial weights.

`utils/prng.py` (threefry keys, `fold_in`, `normal`, flax's key for a
parameter) against jax.random and flax, and the mIoU study's teacher and
student as the port's `build_model_from_arch` builds them against the JAX
package's `build_model_from_arch` for the same seed: every tensor equal,
at least 98 % of the conv values bit for bit and the rest within 5e-7 of
each value (XLA's log1p and erfinv round a few values an ulp or two apart).
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasterseg_tpu.train.driver as jax_driver
from fasterseg_tpu.models.derived import DerivedNet as JaxDerivedNet
from fasterseg_tpu.ops.conv import KAIMING
from fasterseg_tpu_torch.cli.miou_study import ASSETS, study_config
from fasterseg_tpu_torch.train.driver import build_model_from_arch
from fasterseg_tpu_torch.utils import prng
from fasterseg_tpu_torch.utils.weights import from_jax_variables, jax_paths
from _torch_search_common import few_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("seed,data,shape", [
    (0, 0, (7,)), (1, 12345, (3, 3, 16, 32)), (42, 2 ** 32 - 1, (1000,)),
    (7, 3, (2, 5, 1))])
def test_draws_equal_jax_random(seed, data, shape):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(prng.prng_key(seed), np.asarray(key))
    folded = jax.random.fold_in(key, data)
    ours = prng.fold_in(prng.prng_key(seed), data)
    assert np.array_equal(ours, np.asarray(folded))
    want = np.asarray(jax.random.normal(folded, shape, jnp.float32))
    got = prng.normal(ours, shape)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=1e-9)


def test_param_keys_equal_flax_init():
    """Nested explicit and automatic module names, a kernel (the first
    parameter of its module) and the KAIMING draw."""
    class Inner(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Conv(8, (3, 3), kernel_init=KAIMING, name="conv")(x)

    class Outer(nn.Module):
        @nn.compact
        def __call__(self, x):
            return Inner()(Inner(name="stage0")(x))

    v = Outer().init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 4)))
    for path, hwio in ((("stage0", "conv"), (3, 3, 4, 8)),
                       (("Inner_0", "conv"), (3, 3, 8, 8))):
        want = np.asarray(v["params"][path[0]]["conv"]["kernel"])
        got = prng.kaiming_normal(
            prng.flax_param_key(prng.prng_key(3), path), hwio)
        np.testing.assert_allclose(got, want, rtol=5e-7, atol=1e-9)


def _lazy_create_derived(plan, rng, input_hw, dtype=jnp.float32):
    # flax's lazy_init makes the variables init makes, without the forward
    model = JaxDerivedNet(plan=plan, dtype=dtype)
    shape = jax.ShapeDtypeStruct((1, *input_hw, 3), jnp.float32)
    return model, model.lazy_init(rng, shape, train=True)


@pytest.mark.parametrize("stage,arch_idx", [("teacher", 0), ("student", 1)])
def test_study_nets_draw_the_jax_init(stage, arch_idx, monkeypatch):
    monkeypatch.setattr(jax_driver, "create_derived", _lazy_create_derived)
    c = study_config(stage)
    i = c.arch_idx.index(arch_idx)
    path = os.path.join(ASSETS, f"arch_{arch_idx}.npz")
    seed = c.seed + arch_idx
    _, variables, _, _ = jax_driver.build_model_from_arch(
        c, path, arch_idx, c.stem_head_width[i], jax.random.PRNGKey(seed),
        (64, 128))
    net, plan, _ = build_model_from_arch(c, path, arch_idx,
                                         c.stem_head_width[i], seed)
    want = from_jax_variables(plan, jax.tree_util.tree_map(
        np.asarray, dict(variables)))
    own = net.state_dict()
    assert set(want) == {k for k in own
                         if not k.endswith("num_batches_tracked")}
    exact = total = 0
    for k, w in want.items():
        torch.testing.assert_close(own[k], w, rtol=5e-7, atol=1e-9,
                                   msg=k)
        if own[k].dim() == 4:
            exact += int((own[k] == w).sum())
            total += w.numel()
    assert exact >= 0.98 * total


def test_leaf_paths_name_the_jax_leaves():
    plan = build_model_from_arch(study_config("student"),
                                 os.path.join(ASSETS, "arch_1.npz"), 1,
                                 (8 / 12, 8 / 12), 1)[1]
    paths = jax_paths(plan)
    assert paths["stem.0.conv.0.weight"] == (
        "params", "stem", "stage0", "Conv_0", "conv", "kernel")
    assert paths["stem.0.conv.1.running_var"] == (
        "batch_stats", "stem", "stage0", "BatchNorm_0", "bn", "var")
    assert paths["heads8.conv_1x1.bias"] == (
        "params", "heads8", "conv_1x1", "conv", "bias")
