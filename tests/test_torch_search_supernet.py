"""The port's supernet (fasterseg_tpu_torch/models/supernet.py) against the
JAX package's, on the CPU in fp32, at tests/test_supernet.py's size (5
layers, Fch 8, five widths, teacher and student, batch 2 at 64x128).

The same weights on both sides: the port's (training init, BN rows and
statistics randomised) carried to the JAX package's scan layout by the
tests' inverse of `from_jax_supernet_variables`, which must give them back
exactly. Width samples are drawn by JAX and fed to the port.

Bars (fp32; the largest readings on the CPU in brackets): train-mode
heads of (arch 0, max) and (arch 1, arch_ratio) within 1e-3 absolute
[1.0e-4] on logits of magnitude ~5; the BN running statistics after the
forward within 1e-4 + 1e-4 |ref| [7.5e-7 relative], every row whole (both
packages mask, so the entries beyond a row's active prefix match too);
eval-mode heads (x8 upsampled) within 1e-3 [6.3e-7]. One forward's OHEM
loss summed over the five heads within 1e-5 relative; its gradients with
respect to alpha, beta and the ratio logits within 8 % of each tensor's
largest gradient [4.5 %, one beta row], and with respect to every weight
within 10 % of the tensor's largest gradient [3.2 %]. At this size the
gradients are ill-conditioned, as the training slice's step tests found:
BN normalises the 1/32 maps over 16 values a channel, so fp32 rounding
moves deep gradients by percents. The port's own fp32 gradients were 2.0 %
(that beta row) and 3.2 % (weights) from its float64 ones, and JAX's fp32
beta row 2.4 % on the other side.

Remat: one pretrain weight step with `supernet_remat` on equals the step
with it off within 1e-6 (parameters, optimizer momenta and BN running
statistics): the checkpointed recompute moves no statistic a second time.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasterseg_tpu.models.supernet import ArchParamsPytree
from fasterseg_tpu.models.supernet import Supernet as JaxSupernet
from fasterseg_tpu.search.gumbel import sample_ratios as jax_sample_ratios
from fasterseg_tpu.train.loss import ohem_cross_entropy as jax_ohem
from fasterseg_tpu_torch.core.config import SearchConfig
from fasterseg_tpu_torch.models.supernet import (ArchParamSet, Supernet,
                                                 init_supernet)
from fasterseg_tpu_torch.search import SearchEngine, sample_ratios
from fasterseg_tpu_torch.train.loss import ohem_cross_entropy
from fasterseg_tpu_torch.utils.weights import from_jax_supernet_variables

from _torch_search_common import (FCH, HW, LAYERS, SHW, WML, few_threads,
                                  jax_ratio_noise, port_lut, randomize_bn_,
                                  to_jax_supernet_variables, tiny_configs)

MIN_KEPT = 2 * HW[0] * HW[1] // (16 * 64)


@pytest.fixture(scope="module")
def nets():
    model = randomize_bn_(init_supernet(
        Supernet(LAYERS, 19, FCH, WML, SHW), 0), 1)
    jm = JaxSupernet(layers=LAYERS, num_classes=19, Fch=FCH,
                     width_mult_list=WML, stem_head_width=SHW)
    variables = to_jax_supernet_variables(model.state_dict(), LAYERS)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *HW, 3)).astype(np.float32)
    y = rng.integers(0, 19, (2, HW[0] // 8, HW[1] // 8)).astype(np.int32)
    y[0, 0, :3] = 255
    return model, jm, variables, x, y


def _arch(arch_idx, seed):
    """Random arch logits in both packages (numpy-seeded)."""
    ap = ArchParamsPytree.create(LAYERS, num_widths=1 if arch_idx == 0 else 5)
    rng = np.random.default_rng(seed)
    n = lambda a: rng.standard_normal(a.shape).astype(np.float32)
    al, be, ra = ([n(a) for a in ap.alphas], [n(b) for b in ap.betas[1:]],
                  [n(r) for r in ap.ratios])
    jap = ArchParamsPytree([jnp.asarray(a) for a in al],
                           [None] + [jnp.asarray(b) for b in be],
                           [jnp.asarray(r) for r in ra])
    t = lambda a: torch.tensor(a, requires_grad=True)
    tap = ArchParamSet([t(a) for a in al], [None] + [t(b) for b in be],
                       [t(r) for r in ra])
    return jap, tap, ra


def _stats_of(variables, mutated):
    return from_jax_supernet_variables(
        {"params": variables["params"],
         "batch_stats": jax.tree.map(np.asarray, mutated)},
        SearchConfig(layers=LAYERS, stem_head_width=SHW))


def _running(model):
    return {k: v for k, v in model.state_dict().items() if "running" in k}


def test_weights_round_trip(nets):
    model, _, variables, _, _ = nets
    back = from_jax_supernet_variables(
        variables, SearchConfig(layers=LAYERS, stem_head_width=SHW))
    own = model.state_dict()
    assert set(back) == {k for k in own
                         if not k.endswith("num_batches_tracked")}
    for k, v in back.items():
        assert torch.equal(v, own[k]), k
    assert variables["params"]["slayers"]["cell0"]["op"]["op1"]["conv1"][
        "conv"]["kernel"].shape == (LAYERS - 4, 3, 3, 64, 64)


@pytest.mark.parametrize("arch_idx,mode", [(0, "max")])
def test_train_forward_matches_jax(nets, arch_idx, mode):
    model, jm, variables, x, _ = nets
    jap, tap, ra = _arch(arch_idx, 10)
    key = jax.random.PRNGKey(3)
    fwd = jax.jit(lambda v, x, ap, r: jm.apply(
        v, x, arch_idx, ap.alphas, ap.betas, r, train=True,
        mutable=["batch_stats"]))
    want, mut = fwd(variables, x, jap,
                    jax_sample_ratios(key, jap.ratios, mode, 5))
    net = copy.deepcopy(model).train()
    with torch.no_grad():
        got = net(torch.from_numpy(x), arch_idx, tap.alphas, tap.betas,
                  sample_ratios(tap.ratios, mode, 5,
                                noise=jax_ratio_noise(key, ra, mode, 5)))
    for g, w in zip(got, want):
        assert g.shape == (2, HW[0] // 8, HW[1] // 8, 19)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)
    stats = _stats_of(variables, mut["batch_stats"])
    moved = 0
    for k, v in _running(net).items():
        np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
        moved += not torch.equal(v, model.state_dict()[k])
    assert moved > 0


def test_eval_forward_matches_jax(nets):
    model, jm, variables, x, _ = nets
    jap, tap, ra = _arch(1, 11)
    key = jax.random.PRNGKey(4)
    fwd = jax.jit(lambda v, x, ap, r: jm.apply(
        v, x, 1, ap.alphas, ap.betas, r, train=False))
    want = fwd(variables, x, jap,
               jax_sample_ratios(key, jap.ratios, "arch_ratio", 5))
    net = copy.deepcopy(model).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x), 1, tap.alphas, tap.betas,
                  sample_ratios(tap.ratios, "arch_ratio", 5,
                                noise=jax_ratio_noise(key, ra, "arch_ratio",
                                                      5)))
    for g, w in zip(got, want):
        assert g.shape == (2, *HW, 19)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)


def _rel_err(got, want):
    """Largest |got - want| over the tensor's largest |want|."""
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


def test_loss_and_gradients_match_jax(nets):
    """(arch 1, arch_ratio): the train forward and its statistics, the loss
    and its gradients with respect to the weights and every arch tensor."""
    model, jm, variables, x, y = nets
    jap, tap, ra = _arch(1, 12)
    key = jax.random.PRNGKey(5)

    def loss_fn(params, alphas, betas, ratio_logits, stats):
        ratios = jax_sample_ratios(key, ratio_logits, "arch_ratio", 5)
        preds, mut = jm.apply(
            {"params": params, "batch_stats": stats},
            x, 1, alphas, betas, ratios, train=True, mutable=["batch_stats"])
        loss = sum(jax_ohem(p, y, ignore_label=255, thresh=0.7,
                            min_kept=MIN_KEPT) for p in preds)
        return loss, (preds, mut["batch_stats"])

    (loss, (preds, mut)), grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2, 3), has_aux=True))(
        variables["params"], jap.alphas, jap.betas, jap.ratios,
        variables["batch_stats"])

    net = copy.deepcopy(model).train()
    got = net(torch.from_numpy(x), 1, tap.alphas, tap.betas,
              sample_ratios(tap.ratios, "arch_ratio", 5,
                            noise=jax_ratio_noise(key, ra, "arch_ratio", 5)))
    for g, w in zip(got, preds):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-3)
    stats = _stats_of(variables, mut)
    for k, v in _running(net).items():
        np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    t_loss = sum(ohem_cross_entropy(p, torch.from_numpy(y), 255, 0.7,
                                    MIN_KEPT) for p in got)
    np.testing.assert_allclose(float(t_loss.detach()), float(loss),
                               rtol=1e-5)
    t_loss.backward()

    g_alphas, g_betas, g_ratios = grads[1], grads[2], grads[3]
    for t, w in zip(tap.tensors(), list(g_alphas) + list(g_betas[1:])
                    + list(g_ratios)):
        assert np.abs(np.asarray(w)).max() > 0
        assert _rel_err(t.grad.numpy(), w) < 0.08
    g_weights = _stats_of({"params": grads[0],
                           "batch_stats": variables["batch_stats"]},
                          variables["batch_stats"])
    worst, checked = 0.0, 0
    for name, p in net.named_parameters():
        w = g_weights[name].numpy()
        if not np.abs(w).max() > 0:
            continue
        err = _rel_err(p.grad.numpy(), w)
        assert err < 0.10, (name, err)
        worst, checked = max(worst, err), checked + 1
    assert checked > 400


def test_remat_step_equals_plain_step():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, *HW, 3)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(2).integers(
        0, 19, (2, HW[0] // 8, HW[1] // 8)))
    states = []
    for remat in (True, False):
        cfg, _ = tiny_configs(pretrain=True, supernet_remat=remat)
        engine = SearchEngine(cfg, lut=port_lut(), device="cpu")
        assert engine.model.remat == remat
        engine.weight_step(x, y, pretrain=True,
                           generator=torch.Generator().manual_seed(0))
        opt = engine.optimizer.state_dict()["state"]
        states.append((engine.model.state_dict(),
                       [opt[i]["momentum_buffer"] for i in sorted(opt)]))
    (a, ma), (b, mb) = states
    for k in a:
        if a[k].is_floating_point():
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
        else:
            assert torch.equal(a[k], b[k]), k
    assert len(ma) == len(mb) > 0
    for u, v in zip(ma, mb):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=0, atol=1e-6)
