"""fasterseg_tpu_torch serving path against the JAX package on the CPU, fp32.

The port runs with device="cpu", where every kernel wrapper takes its plain
version; the JAX side runs its Pallas kernels in interpret mode. Weights and
inputs come from `_both` (tests/test_torch_weights.py): seeded JAX variables
converted with `from_jax_variables`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasterseg_tpu.models import InferenceRunner as JaxRunner
import fasterseg_tpu_torch.models as tmodels
from fasterseg_tpu_torch.models import DerivedNet, InferenceRunner
from test_torch_weights import HW, _both


def test_runner_logits_and_classmap_match_jax():
    """Port InferenceRunner (kernel path, plain versions on the CPU) against
    the JAX InferenceRunner (Pallas stem + fast body, interpret mode)."""
    jplan, _, variables, tplan, net, x = _both("student")
    jr = JaxRunner(jplan, variables, dtype=jnp.float32)
    want = np.asarray(jr.logits(variables, jnp.asarray(x)))
    runner = InferenceRunner(tplan, net, dtype=torch.float32, device="cpu")
    xt = torch.from_numpy(x)
    got = runner.logits(xt).numpy()
    assert got.shape == want.shape == (1, *HW, 19)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)

    cm = runner.classmap(xt).numpy()
    assert cm.shape == (1, *HW) and cm.dtype == np.int32
    # against the contract (argmax of the full-resolution JAX logits): any
    # pixel that differs is a near-tie of the JAX logits
    differ = cm != np.argmax(want, -1)
    assert differ.mean() <= 1e-4
    top2 = np.sort(want, -1)[..., -2:]
    assert np.all((top2[..., 1] - top2[..., 0])[differ] < 1e-4)
    # against the JAX class map, whose Pallas kernel rounds its interpolation
    # to bf16 (pallas/fused.py:53,77-78): the Pallas kernel's own bar
    jcm = np.asarray(jr.classmap(variables, jnp.asarray(x)))
    assert (cm == jcm).mean() >= 0.995


@pytest.mark.parametrize("name", ["synthetic", "passthrough"])
def test_fast_body_matches_plain(name):
    """Port kernel path (stem + fast body) == port plain DerivedNet == the
    kernel stem + plain body, fp32: every primitive at both strides."""
    _, _, _, tplan, net, x = _both(name, seed=1)
    xt = torch.from_numpy(x)
    plain = InferenceRunner(tplan, net, dtype=torch.float32, device="cpu",
                            fast_stem_enabled=False)
    want = plain.logits(xt)
    for kwargs in ({}, {"fast_body_enabled": False}):
        fast = InferenceRunner(tplan, net, dtype=torch.float32, device="cpu",
                               **kwargs)
        torch.testing.assert_close(fast.p8(xt), plain.p8(xt),
                                   rtol=5e-4, atol=5e-4)
        torch.testing.assert_close(fast.logits(xt), want,
                                   rtol=5e-4, atol=5e-4)
        np.testing.assert_array_equal(fast.classmap(xt).numpy(),
                                      plain.classmap(xt).numpy())


def test_runner_casts_to_its_dtype():
    """A bf16 runner takes an fp32 image and returns bf16 logits and an int32
    class map of the image's size."""
    plan = tmodels.student_plan()
    net = DerivedNet(plan)
    runner = InferenceRunner(plan, net, dtype=torch.bfloat16, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 64, 128, 3)).astype(np.float32))
    logits = runner.logits(x)
    assert logits.dtype == torch.bfloat16
    assert tuple(logits.shape) == (1, 64, 128, 19)
    assert bool(torch.isfinite(logits.float()).all())
    cm = runner.classmap(x)
    assert cm.dtype == torch.int32 and tuple(cm.shape) == (1, 64, 128)


def test_runner_defaults_to_cuda(monkeypatch):
    """The entry point runs on the card by default and raises without one,
    rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = tmodels.student_plan()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceRunner(plan, DerivedNet(plan))


def test_cpu_path_counts_no_launches():
    """On the CPU every wrapper takes its plain version and no kernel is
    launched, so no launch counter moves."""
    from fasterseg_tpu_torch import kernels
    plan = tmodels.student_plan()
    runner = InferenceRunner(plan, DerivedNet(plan), dtype=torch.float32,
                             device="cpu")
    x = torch.zeros(1, 64, 128, 3)
    kernels.reset_launch_counts()
    runner.logits(x)
    runner.classmap(x)
    assert set(kernels.launch_counts().values()) == {0}
