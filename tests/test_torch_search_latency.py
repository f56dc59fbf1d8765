"""The port's latency modules, Gumbel sampling, architect and step algebra
against the JAX package, on the CPU.

* The LUT, the supernet tables, the stems and the decoded networks'
  estimates (numpy copies) equal the JAX package's exactly on the reference
  table (the port's default, shipped inside the package).
* The estimator (a torch contraction) against `expected_latency_ms` and
  `jax.grad` of it, use_alpha and use_beta each on and off: values and
  gradients (alphas, betas, ratio logits) within 1e-5 + 1e-5 |ref| (fp32).
* `sample_ratios` in each mode on JAX's draws: the same indices, scores
  within 1e-6 and their gradients within 1e-6 + 1e-5 |ref|.
* `latency_terms` (the alpha/beta/ratio split) against the JAX package's
  within 1e-5 relative, gradients within 1e-5 + 1e-5 |ref|.
* The weight step's algebra against optax on small tensors, rtol 1e-6: the
  global-norm clip on both sides of its threshold; SGD with decayed weights
  at the staircase rate; and the arch optimizer against optax.adam.
* The latency-weight controller's cap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fasterseg_tpu.latency import LatencyLUT as JaxLUT
from fasterseg_tpu.latency import build_supernet_tables as jax_tables
from fasterseg_tpu.latency import derived_latency_ms as jax_derived
from fasterseg_tpu.latency import expected_latency_ms as jax_expected
from fasterseg_tpu.latency import stem_latency_ms as jax_stem
from fasterseg_tpu.models import student_plan as jax_student_plan
from fasterseg_tpu.models import teacher_plan as jax_teacher_plan
from fasterseg_tpu.models.supernet import ArchParamsPytree
from fasterseg_tpu.search.architect import latency_terms as jax_latency_terms
from fasterseg_tpu.search.gumbel import sample_ratios as jax_sample_ratios
from fasterseg_tpu_torch.latency import (LatencyLUT, build_supernet_tables,
                                         derived_latency_ms,
                                         expected_latency_ms, reference_lut,
                                         stem_latency_ms)
from fasterseg_tpu_torch.latency.lut import REFERENCE_LUT
from fasterseg_tpu_torch.models import student_plan, teacher_plan
from fasterseg_tpu_torch.models.supernet import ArchParamSet
from fasterseg_tpu_torch.search import (LatencyWeightController,
                                        clip_by_global_norm_, latency_terms,
                                        make_arch_optimizer, sample_ratios)
from fasterseg_tpu_torch.train import make_optimizer, set_learning_rate

from _torch_search_common import LAYERS, WML, few_threads, jax_ratio_noise

FULL_WML = WML


def _arch(seed, num_widths=5, layers=LAYERS):
    """Random arch logits, as numpy, in ArchParamsPytree's shapes."""
    rng = np.random.default_rng(seed)
    ap = ArchParamsPytree.create(layers, num_widths=num_widths)
    n = lambda a: rng.standard_normal(a.shape).astype(np.float32)
    return ([n(a) for a in ap.alphas], [None, n(ap.betas[1]),
                                        n(ap.betas[2])],
            [n(r) for r in ap.ratios])


def _port_arch(np_arch):
    alphas, betas, ratios = np_arch
    t = lambda a: torch.tensor(a, requires_grad=True)
    return ArchParamSet([t(a) for a in alphas], [None] + [t(b) for b in
                                                          betas[1:]],
                        [t(r) for r in ratios])


def _jax_arch(np_arch):
    alphas, betas, ratios = np_arch
    return ArchParamsPytree([jnp.asarray(a) for a in alphas],
                            [None] + [jnp.asarray(b) for b in betas[1:]],
                            [jnp.asarray(r) for r in ratios])


def test_reference_lut_and_tables_match_jax(assets_dir):
    with open(REFERENCE_LUT) as f, open(f"{assets_dir}/reference_lut.json") \
            as g:
        assert f.read() == g.read()
    port = reference_lut()
    ref = JaxLUT(f"{assets_dir}/reference_lut.json", alias_op4=True)
    assert len(port) == len(ref) == 667
    a = build_supernet_tables(port, 16, 12, FULL_WML, (1024, 2048))
    b = jax_tables(ref, 16, 12, FULL_WML, (1024, 2048))
    for k in ("keep", "down"):
        assert a[k].shape == (16, 3, 5, 5, 5)
        np.testing.assert_array_equal(a[k], b[k])
    for w in (1.0, 8.0 / 12):
        assert stem_latency_ms(port, 12, w) == jax_stem(ref, 12, w)
    for tp, jp in ((student_plan(), jax_student_plan()),
                   (teacher_plan(), jax_teacher_plan())):
        assert derived_latency_ms(port, tp) == jax_derived(ref, jp)
    with pytest.raises(KeyError, match="no provider"):
        port.get("ConvNorm_H1_W1_Cin1_Cout1_kernel1_stride1")


@pytest.fixture(scope="module")
def random_tables():
    rng = np.random.default_rng(7)
    keep = rng.uniform(0.1, 2.0, (LAYERS, 3, 5, 5, 5)).astype(np.float32)
    down = rng.uniform(0.1, 2.0, (LAYERS, 3, 5, 5, 5)).astype(np.float32)
    return {"keep": keep, "down": down}


@pytest.mark.parametrize("use_alpha,use_beta", [(True, True), (True, False),
                                                (False, True),
                                                (False, False)])
def test_estimator_values_and_gradients_match_jax(random_tables, use_alpha,
                                                  use_beta):
    np_arch = _arch(1)
    key = jax.random.PRNGKey(11)
    stem_ms, stem_pin, head_pin = 3.5, 4, 2
    jt = {k: jnp.asarray(v) for k, v in random_tables.items()}

    def jax_lat(alphas, betas, ratio_logits):
        ratios = jax_sample_ratios(key, ratio_logits, "arch_ratio", 5)
        return jax_expected(jt, stem_ms, alphas, betas, ratios, LAYERS,
                            (jnp.int32(stem_pin), jnp.float32(1.0)),
                            (jnp.int32(head_pin), jnp.float32(1.0)),
                            use_alpha=use_alpha, use_beta=use_beta)

    ja = _jax_arch(np_arch)
    want, grads = jax.value_and_grad(jax_lat, argnums=(0, 1, 2))(
        ja.alphas, ja.betas, ja.ratios)

    ap = _port_arch(np_arch)
    noise = jax_ratio_noise(key, np_arch[2], "arch_ratio", 5)
    ratios = sample_ratios(ap.ratios, "arch_ratio", 5, noise=noise)
    one = torch.ones(())
    got = expected_latency_ms(
        {k: torch.from_numpy(v) for k, v in random_tables.items()}, stem_ms,
        ap.alphas, ap.betas, ratios, LAYERS,
        (torch.tensor(stem_pin), one), (torch.tensor(head_pin), one),
        use_alpha=use_alpha, use_beta=use_beta)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    got.backward()
    for t, g in zip(ap.alphas + ap.betas[1:] + ap.ratios,
                    list(grads[0]) + list(grads[1][1:]) + list(grads[2])):
        np.testing.assert_allclose(_grad(t), np.asarray(g), rtol=1e-5,
                                   atol=1e-5)
    assert any(float(jnp.abs(g).max()) > 0 for g in grads[2])


@pytest.mark.parametrize("mode", ["arch_ratio", "min", "max", "random"])
@pytest.mark.parametrize("num_widths", [5, 1])
def test_sample_ratios_match_jax_on_its_draws(mode, num_widths):
    np_ratios = _arch(2, num_widths=num_widths)[2]
    key = jax.random.PRNGKey(5)
    weights = [np.random.default_rng(i).standard_normal(r.shape[0]).astype(
        np.float32) for i, r in enumerate(np_ratios)]

    def jax_fn(logits):
        out = jax_sample_ratios(key, logits, mode, 5)
        return sum(jnp.sum(s * w) for (_, s), w in zip(out, weights)), out

    (_, want), grads = jax.value_and_grad(jax_fn, has_aux=True)(
        [jnp.asarray(r) for r in np_ratios])
    logits = [torch.tensor(r, requires_grad=True) for r in np_ratios]
    got = sample_ratios(logits, mode, 5,
                        noise=jax_ratio_noise(key, np_ratios, mode, 5))
    for (gi, gs), (wi, ws) in zip(got, want):
        assert gi.dtype == torch.int64
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gs.detach().numpy(), np.asarray(ws),
                                   atol=1e-6)
    total = sum((s * torch.from_numpy(w)).sum()
                for (_, s), w in zip(got, weights))
    if total.requires_grad:      # constant scores outside arch_ratio
        total.backward()
    for t, g in zip(logits, grads):
        np.testing.assert_allclose(_grad(t), np.asarray(g), rtol=1e-5,
                                   atol=1e-6)
    # the generator path draws the same shapes and keeps the same contract
    drawn = sample_ratios(logits, mode, 5, torch.Generator().manual_seed(0))
    for (gi, gs), (wi, _) in zip(drawn, want):
        assert gi.shape == tuple(wi.shape) and 0 <= int(gi.min()) \
            and int(gi.max()) < 5
        np.testing.assert_allclose(gs.detach().numpy(), 1.0, atol=1e-6)


def test_latency_terms_match_jax(random_tables):
    """Both archs of a search (teacher 'max' with 1-wide ratios, student
    'arch_ratio'), the reference's 1/497/2 split, stem and head pins."""
    archs = {0: _arch(3, num_widths=1), 1: _arch(4)}
    stem_ms = [4.4, 2.1]
    pins = [(4, 4), (2, 2)]
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    jt = {k: jnp.asarray(v) for k, v in random_tables.items()}

    def jax_fn(aps):
        lats = jax_latency_terms(
            jt, stem_ms, aps, keys, LAYERS, 5, ("max", "arch_ratio"),
            [(jnp.int32(s), jnp.float32(1.0)) for s, _ in pins],
            [(jnp.int32(h), jnp.float32(1.0)) for _, h in pins])
        return lats[0] + 3.0 * lats[1], lats

    japs = {i: _jax_arch(a) for i, a in archs.items()}
    (_, want), grads = jax.value_and_grad(jax_fn, has_aux=True)(japs)

    aps = {i: _port_arch(a) for i, a in archs.items()}
    noise = {0: [None] * 3,
             1: jax_ratio_noise(keys[1], archs[1][2], "arch_ratio", 5)}
    one = torch.ones(())
    lats = latency_terms(
        {k: torch.from_numpy(v) for k, v in random_tables.items()}, stem_ms,
        aps, LAYERS, 5, ("max", "arch_ratio"),
        [(torch.tensor(s), one) for s, _ in pins],
        [(torch.tensor(h), one) for _, h in pins], noise=noise)
    for i in (0, 1):
        np.testing.assert_allclose(float(lats[i].detach()), float(want[i]),
                                   rtol=1e-5)
    (lats[0] + 3.0 * lats[1]).backward()
    for i in (0, 1):
        g = grads[i]
        for t, w in zip(aps[i].tensors(), list(g.alphas) + list(g.betas[1:])
                        + list(g.ratios)):
            np.testing.assert_allclose(_grad(t), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def _grad(t):
    """t's gradient; zeros where autograd left none (JAX's zeros)."""
    return (torch.zeros_like(t) if t.grad is None else t.grad).numpy()


def _tensors(seed, scale):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in ((3, 4), (5,), (2, 2, 3))]


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_global_norm_clip_matches_optax(scale):
    grads = _tensors(0, scale)
    want, _ = optax.clip_by_global_norm(5.0).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(got, 5.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(
        [jnp.asarray(g) for g in grads])), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_weight_sgd_with_decay_and_staircase_matches_optax():
    """optax.chain(add_decayed_weights(5e-4), sgd(exponential_decay(2e-2,
    2, 0.978, staircase), momentum 0.9)) over four updates, the rate
    dropping after two: the pretrain weight optimizer."""
    params = _tensors(1, 1.0)
    grads = [_tensors(10 + k, 1.0) for k in range(4)]
    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.sgd(
        optax.exponential_decay(2e-2, 2, 0.978, staircase=True),
        momentum=0.9))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = make_optimizer(tp, 2e-2, 0.9, 5e-4, 0.978, 2)
    for k, g in enumerate(grads):
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        set_learning_rate(opt, k)
        opt.step()
        for t, w in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)
    assert opt.param_groups[0]["lr"] == pytest.approx(2e-2 * 0.978)


def test_arch_optimizer_matches_optax_adam():
    """Each of three updates within 1e-4 of its size (relative) and the
    parameters within 1e-6 relative. optax computes Adam's bias correction
    1 - 0.999^t in fp32, where it cancels (1 - 0.999f = 0.0010000467, 4.7e-5
    off), torch in float64; so the first updates differ by ~2.3e-5 of their
    size."""
    params = _tensors(2, 1e-3)
    grads = [_tensors(20 + k, 1.0) for k in range(3)]
    tx = optax.adam(3e-4, b1=0.5, b2=0.999)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = make_arch_optimizer(tp, 3e-4)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        before = [t.detach().clone() for t in tp]
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        opt.step()
        for t, b, u, w in zip(tp, before, upd, jp):
            np.testing.assert_allclose((t.detach() - b).numpy(),
                                       np.asarray(u), rtol=1e-4, atol=1e-10)
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-8)


def test_latency_weight_controller_cap():
    """The doubling is capped at initial * 2^max_doublings (PARITY.md), as
    the JAX package's tests/test_search.py holds it."""
    c = LatencyWeightController([0.0, 1e-2], fps_min=[0.0, 100.0],
                                fps_max=[0.0, 120.0], max_doublings=4)
    for _ in range(20):
        w = c.update(1, 50.0, 50.0)
    assert w == pytest.approx(1e-2 * 16)
    assert c.update(1, 500.0, 500.0) == pytest.approx(1e-2 * 8)
    assert c.update(0, 50.0, 50.0) == 0.0
    assert LatencyWeightController([1e-2], [0.0], [1.0]).max_weights == \
        [pytest.approx(1e-2 * 256)]
    # inside the band: unchanged
    c = LatencyWeightController([0.0, 1e-2], [0.0, 155.0], [0.0, 175.0])
    assert c.update(1, 160.0, 170.0) == 1e-2
    assert c.update(1, 150.0, 170.0) == 2e-2
    assert c.update(1, 160.0, 180.0) == 1e-2
