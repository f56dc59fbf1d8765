"""fasterseg_tpu_torch.train.loss against the reference goldens and the JAX
package's losses, values and gradients with respect to the logits.

tests/assets/golden_losses.npz holds the reference ProbOhemCrossEntropy2d
(thresh 0.6) on four cases and nn.KLDivLoss on one, as tests/test_losses.py
reads them; the bar is that test's rel 1e-5. Against the JAX functions on
the same numpy-seeded inputs: values to rtol 1e-5, gradients to atol 1e-6
(rtol 1e-4), both fp32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasterseg_tpu.train import loss as jloss
from fasterseg_tpu_torch.train import loss as tloss


@pytest.fixture(scope="module")
def golden(assets_dir):
    return np.load(os.path.join(assets_dir, "golden_losses.npz"))


@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_ohem_matches_reference_golden(golden, case):
    pred = torch.from_numpy(golden[f"case{case}/pred"])
    tgt = torch.from_numpy(golden[f"case{case}/target"].astype(np.int64))
    got = float(tloss.ohem_cross_entropy(
        pred, tgt, ignore_label=255, thresh=0.6,
        min_kept=int(golden[f"case{case}/min_kept"])))
    assert got == pytest.approx(float(golden[f"case{case}/loss"]), rel=1e-5)


def test_kl_matches_reference_golden(golden):
    got = float(tloss.kl_distillation(torch.from_numpy(golden["kl/student"]),
                                      torch.from_numpy(golden["kl/teacher"])))
    assert got == pytest.approx(float(golden["kl/loss"]), rel=1e-5)


def _inputs(seed, shape=(2, 12, 16), c=19, ignore_share=0.2, scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((*shape, c)) * scale).astype(np.float32)
    target = rng.integers(0, c, shape).astype(np.int32)
    target[rng.random(shape) < ignore_share] = 255
    return logits, target


N_PIXELS = 2 * 12 * 16


# (name, port fn, JAX fn, kwargs); min_kept above and below the number of
# valid pixels takes OHEM's two branches (plain CE over the valid pixels, and
# the k-th smallest threshold); the class weights are Cityscapes'.
CASES = [
    ("ce", tloss.cross_entropy, jloss.cross_entropy, {}),
    ("ce weighted", tloss.cross_entropy, jloss.cross_entropy,
     {"class_weight": np.asarray(tloss.CITYSCAPES_CLASS_WEIGHTS, np.float32)}),
    ("ohem, min_kept > valid", tloss.ohem_cross_entropy,
     jloss.ohem_cross_entropy, {"thresh": 0.7, "min_kept": N_PIXELS}),
    ("ohem, min_kept < valid", tloss.ohem_cross_entropy,
     jloss.ohem_cross_entropy, {"thresh": 0.7, "min_kept": 40}),
    ("ohem, low thresh", tloss.ohem_cross_entropy, jloss.ohem_cross_entropy,
     {"thresh": 0.05, "min_kept": 40}),
    ("ohem weighted", tloss.ohem_cross_entropy, jloss.ohem_cross_entropy,
     {"thresh": 0.7, "min_kept": 40,
      "class_weight": np.asarray(tloss.CITYSCAPES_CLASS_WEIGHTS, np.float32)}),
    ("ohem topk, few over thresh", tloss.ohem_ce_topk, jloss.ohem_ce_topk,
     {"n_min": 100, "thresh": 0.01}),
    ("ohem topk, many over thresh", tloss.ohem_ce_topk, jloss.ohem_ce_topk,
     {"n_min": 10, "thresh": 0.7}),
    ("focal", tloss.focal_loss, jloss.focal_loss, {"gamma": 2.0}),
]


def _both(tfn, jfn, kw, logits, target):
    """(port value, port grad, JAX value, JAX grad) of the loss."""
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tfn(x, torch.from_numpy(target).long(), **tkw)
    got.backward()
    want, wgrad = jax.value_and_grad(
        lambda z: jfn(z, jnp.asarray(target), **jkw))(jnp.asarray(logits))
    return float(got.detach()), x.grad.numpy(), float(want), np.asarray(wgrad)


@pytest.mark.parametrize("name,tfn,jfn,kw", CASES, ids=[c[0] for c in CASES])
def test_loss_and_grad_match_jax(name, tfn, jfn, kw):
    logits, target = _inputs(0)
    got, ggrad, want, wgrad = _both(tfn, jfn, kw, logits, target)
    assert got == pytest.approx(want, rel=1e-5)
    np.testing.assert_allclose(ggrad, wgrad, rtol=1e-4, atol=1e-6)


def test_ohem_branches_differ_from_plain_ce():
    """The mining branch keeps fewer pixels than plain CE: min_kept below
    the valid count gives another loss than min_kept above it, which equals
    plain CE over the valid pixels."""
    logits, target = _inputs(1)
    x, t = torch.from_numpy(logits), torch.from_numpy(target).long()
    ce = float(tloss.cross_entropy(x, t))
    all_kept = float(tloss.ohem_cross_entropy(x, t, thresh=1.0 - 1e-9,
                                              min_kept=N_PIXELS))
    mined = float(tloss.ohem_cross_entropy(x, t, thresh=0.05, min_kept=40))
    assert all_kept == pytest.approx(ce, rel=1e-6)
    assert mined > ce


@pytest.mark.parametrize("seed", [0, 1])
def test_kl_and_soft_ce_match_jax(seed):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((2, 6, 8, 19)) * 2).astype(np.float32)
    t = (rng.standard_normal((2, 6, 8, 19)) * 2).astype(np.float32)
    soft = np.array(jax.nn.softmax(jnp.asarray(t), -1))
    for tfn, jfn, other in ((tloss.kl_distillation, jloss.kl_distillation, t),
                            (tloss.soft_cross_entropy,
                             jloss.soft_cross_entropy, soft)):
        x = torch.from_numpy(s).requires_grad_(True)
        got = tfn(x, torch.from_numpy(other))
        got.backward()
        want, wgrad = jax.value_and_grad(
            lambda z: jfn(z, jnp.asarray(other)))(jnp.asarray(s))
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(wgrad),
                                   rtol=1e-4, atol=1e-6)


def test_ohem_mask_carries_no_gradient():
    """Pixels OHEM drops get exactly zero gradient, as in JAX."""
    logits, target = _inputs(2)
    x = torch.from_numpy(logits).requires_grad_(True)
    t = torch.from_numpy(target).long()
    tloss.ohem_cross_entropy(x, t, thresh=0.05, min_kept=40).backward()
    with torch.no_grad():
        p = torch.softmax(x, -1).gather(-1, t.clamp(max=18)[..., None])[..., 0]
    threshold = max(torch.sort(p[t != 255]).values[39].item(), 0.05)
    dropped = (t == 255) | (p > threshold)
    assert dropped.any()
    assert torch.all(x.grad[dropped] == 0)
