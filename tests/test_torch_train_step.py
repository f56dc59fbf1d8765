"""The port's train step against the JAX package's `make_train_step`, on the
CPU in fp32, from the same weights (`from_jax_variables`).

Teacher mode runs on the shipped student plan; student mode on the shipped
student plan with a frozen synthetic 19-class teacher and OHEM mining
(thresh 0.1 keeps fewer than all pixels). Batch 2 at 64x128, two updates
with `steps_per_epoch=1`, so the staircase learning rate decays between
them (0.01, then 0.00992). Three JAX compiles: the train-mode forward and
the two steps.

This net is ill-conditioned at this size: train-mode BN normalises with the
statistics of few values (16 a channel at 1/32), so fp32 rounding moves the
gradient of a deep layer by percents. On the second batch, from the same
weights, the JAX package's own parameter gradients are up to 6.7 % (of the
tensor's largest gradient) from a float64 run and the port's 2.4 %; the two
packages' weights after two free-running updates differ by up to 40 % of the
update. So each update is held from the same state: the first from the
shared init, the second from the JAX state after the first (weights,
statistics and momentum loaded into the port).

Bars (fp32): train-mode (p8, p16, p32) 1e-3 (the JAX package's p8 is 5.4e-4
and the port's 3.3e-4 from a float64 forward of the same net); loss and
loss_kl rtol 1e-5 on the first update, 1e-4 on the second; inter / union
exactly as the JAX package's `batch_intersection_union` counts them on the
port's p8, and against the JAX step's up to the near-tie pixels (top-2
margin of p8 under twice its bar, each of which may move two classes'
counts by one); every parameter and BN running statistic after an update
within 10 % of that update's largest step in the tensor, plus 1e-6 (read:
at most 3.8 % on the first update and 5.3 % on the second). The optimizer alone is held to optax
exactly (rtol 1e-6) in `test_optimizer_matches_optax`. The teacher-mode
step with `grad_clip` set to a quarter of the first update's unclipped norm
(optax's global-norm clip, which binds on both updates) is held to the same
bars (one more JAX compile), and a clip that does not bind leaves the
update bit for bit as it is.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fasterseg_tpu.core.genotype import Genotype, path_to_downs
from fasterseg_tpu.core.plan import build_plan as jax_build_plan
from fasterseg_tpu.eval.metrics import batch_intersection_union
from fasterseg_tpu.models import create_derived
from fasterseg_tpu.models import student_plan as jax_student_plan
from fasterseg_tpu.train.loop import (create_train_state,
                                      make_optimizer as jax_make_optimizer,
                                      make_train_step)
import fasterseg_tpu_torch.core as tcore
from fasterseg_tpu_torch.models import DerivedNet, student_plan
from fasterseg_tpu_torch.train import (TrainState, learning_rate,
                                       make_optimizer, set_learning_rate,
                                       train_step)
from fasterseg_tpu_torch.utils import from_jax_variables, load_reference_state_dict

HW = (64, 128)
BATCH = 2
MIN_KEPT = BATCH * HW[0] * HW[1] // 16
OPT = dict(lr=0.01, momentum=0.9, weight_decay=5e-4, lr_decay=0.992,
           steps_per_epoch=1)


def _teacher_plans():
    """A 19-class synthetic plan (lasts=(2,1), skip / conv / conv_2x down
    cells), built by each package."""
    def geno(core, ops, path):
        return core.Genotype(ops=tuple(ops), path=tuple(path),
                             downs=tuple(path_to_downs(path)),
                             widths=tuple([1.0] * (len(path) - 1)))

    class JaxCore:
        Genotype = Genotype
        build_plan = staticmethod(jax_build_plan)

    def plan(core):
        return core.build_plan({2: geno(core, (1, 0, 0, 1), (0, 0, 1, 2)),
                                1: geno(core, (0, 3, 1), (0, 0, 1))},
                               [2, 1], Fch=8, num_classes=19,
                               stem_head_width=(1.0, 1.0))
    return plan(JaxCore), plan(tcore)


def _nets(jplan, tplan, seed):
    """The JAX model and variables (its train init) and the port's net
    loaded with them (aux heads included)."""
    model, variables = create_derived(jplan, jax.random.PRNGKey(seed),
                                      input_hw=HW, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    net = DerivedNet(tplan)
    load_reference_state_dict(net, from_jax_variables(tplan, variables))
    return model, variables, net


def _batches(seed, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((BATCH, *HW, 3)).astype(np.float32)
        y = rng.integers(0, 19, (BATCH, *HW)).astype(np.int32)
        y[rng.random((BATCH, *HW)) < 0.1] = 255
        out.append((x, y))
    return out


def _jax_state_dict(tplan, tree, stats):
    return from_jax_variables(tplan, jax.tree_util.tree_map(
        np.asarray, {"params": tree, "batch_stats": stats}))


def _sync(state, tplan, jstate):
    """Load the JAX state (weights, statistics, momentum trace, update
    count) into the port's."""
    net, opt = state.model, state.optimizer
    net.load_state_dict(_jax_state_dict(tplan, jstate.params,
                                        jstate.batch_stats), strict=False)
    trace = _jax_state_dict(tplan, jstate.opt_state[1][0].trace,
                            jstate.batch_stats)
    for name, p in net.named_parameters():
        opt.state[p]["momentum_buffer"] = trace[name].clone()
    state.step = int(jstate.step)


def _check_update(net, before, tplan, jstate):
    """Every tensor within 10 % of the JAX update's largest step in it."""
    want = _jax_state_dict(tplan, jstate.params, jstate.batch_stats)
    got = net.state_dict()
    assert set(want) == {k for k in got
                         if not k.endswith("num_batches_tracked")}
    for k, w in want.items():
        step = (w - before[k]).abs().max().item()
        err = (got[k] - w).abs().max().item()
        assert err <= 0.1 * step + 1e-6, (k, err, step)


def _check_metrics(tm, jm, p8, y, rel):
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=rel)
    assert float(tm["loss_kl"]) == pytest.approx(float(jm["loss_kl"]),
                                                 rel=rel)
    inter, union = (np.asarray(a) for a in batch_intersection_union(
        jnp.asarray(p8), jnp.asarray(y), 19))
    np.testing.assert_array_equal(tm["inter"].numpy(), inter)
    np.testing.assert_array_equal(tm["union"].numpy(), union)
    top2 = np.sort(p8, -1)[..., -2:]
    ties = int((top2[..., 1] - top2[..., 0] < 2e-3).sum())
    assert np.abs(inter - jm["inter"]).sum() <= 2 * ties
    assert np.abs(union - jm["union"]).sum() <= 2 * ties


def _run_both(seed, teacher=None, thresh=0.7, grad_clip=None):
    """Two updates in each package, the second from the JAX state after
    the first; checks each; returns the port's state."""
    jplan, tplan = jax_student_plan(), student_plan()
    model, variables, net = _nets(jplan, tplan, seed)
    tx = jax_make_optimizer(**OPT)
    jstate = create_train_state(variables, tx)
    kw = dict(min_kept=MIN_KEPT, thresh=thresh, aux_weight=0.2,
              num_classes=19, grad_clip=grad_clip)
    tnet, extra = None, ()
    if teacher is not None:
        tmodel, tvars, tnet = teacher
        extra = ({"params": tvars["params"],
                  "batch_stats": tvars["batch_stats"]},)
        jstep = jax.jit(make_train_step(model, tx, teacher_model=tmodel,
                                        **kw))
    else:
        jstep = jax.jit(make_train_step(model, tx, **kw))
    state = TrainState(net, make_optimizer(net.parameters(), **OPT))
    for i, (x, y) in enumerate(_batches(seed + 1)):
        if i:
            _sync(state, tplan, jstate)
        before = copy.deepcopy(net.state_dict())
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), *extra)
        # the step's own p8: the same train-mode forward of the same weights
        # (deterministic on the CPU), on a copy whose statistics may move
        with torch.no_grad():
            p8 = copy.deepcopy(net).train()(torch.from_numpy(x))[0].numpy()
        tm = train_step(state, torch.from_numpy(x), torch.from_numpy(y),
                        tnet, **kw)
        assert (float(tm["loss_kl"]) > 0) == (teacher is not None)
        _check_metrics(tm, jax.tree_util.tree_map(np.asarray, jm), p8, y,
                       rel=1e-5 if i == 0 else 1e-4)
        _check_update(net, before, tplan, jstate)
    assert state.step == int(jstate.step) == 2
    return state


def test_train_mode_outputs_match_jax():
    """(p8, p16, p32) of the train-mode forward, fp32 at the input
    resolution, and the running statistics it leaves."""
    jplan, tplan = jax_student_plan(), student_plan()
    model, variables, net = _nets(jplan, tplan, 0)
    x = _batches(1, 1)[0][0]
    (w8, w16, w32), upd = jax.jit(lambda v, z: model.apply(
        v, z, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    net.train()
    got = net(torch.from_numpy(x))
    for g, w in zip(got, (w8, w16, w32)):
        assert g.dtype == torch.float32 and g.shape == (BATCH, *HW, 19)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-3, atol=1e-3)
    want = _jax_state_dict(tplan, variables["params"], upd["batch_stats"])
    for k, v in net.state_dict().items():
        if k in want and "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_teacher_mode_step_matches_jax():
    """No KL term; the trained plan is the shipped student's."""
    state = _run_both(0)
    group = state.optimizer.param_groups[0]
    assert [learning_rate(group, k) for k in (0, 1)] == pytest.approx(
        [0.01, 0.00992], rel=1e-12)
    assert group["lr"] == pytest.approx(0.00992, rel=1e-12)


def test_student_mode_step_matches_jax():
    """KL distillation from a frozen synthetic teacher, whose weights and
    statistics stay as they were."""
    jt, tt = _teacher_plans()
    tmodel, tvars, tnet = _nets(jt, tt, 5)
    before = copy.deepcopy(tnet.state_dict())
    _run_both(0, teacher=(tmodel, tvars, tnet), thresh=0.1)
    for k, v in tnet.state_dict().items():
        assert torch.equal(v, before[k]), k


def _spy_clip(monkeypatch):
    """The global norms `train_step`'s clip reads, in order."""
    import fasterseg_tpu_torch.train.loop as loop
    norms, real = [], loop.clip_by_global_norm_

    def spy(grads, max_norm):
        total = real(grads, max_norm)
        norms.append(float(total))
        return total
    monkeypatch.setattr(loop, "clip_by_global_norm_", spy)
    return norms


def test_teacher_mode_step_with_grad_clip_matches_jax(monkeypatch):
    """`train_step(grad_clip=c)` against `make_train_step(grad_clip=c)`
    (optax's global-norm clip before the decayed-weight SGD), at a c a
    quarter of the first update's unclipped norm, so the clip binds on
    both updates; the bars of the unclipped step."""
    norms = _spy_clip(monkeypatch)
    jplan, tplan = jax_student_plan(), student_plan()
    _, _, net = _nets(jplan, tplan, 0)
    x, y = _batches(1)[0]
    state = TrainState(net, make_optimizer(net.parameters(), **OPT))
    train_step(state, torch.from_numpy(x), torch.from_numpy(y),
               min_kept=MIN_KEPT, grad_clip=float("inf"))
    clip = norms.pop() / 4
    _run_both(0, grad_clip=clip)
    assert len(norms) == 2 and min(norms) > clip, (norms, clip)


def test_grad_clip_that_does_not_bind_changes_nothing(monkeypatch):
    """A clip above the gradients' norm leaves the update bit for bit as
    it is without one."""
    norms = _spy_clip(monkeypatch)
    jplan, tplan = jax_student_plan(), student_plan()
    _, _, net = _nets(jplan, tplan, 0)
    x, y = (torch.from_numpy(a) for a in _batches(1)[0])
    out = []
    for clip in (None, 1e9):
        n = copy.deepcopy(net)
        state = TrainState(n, make_optimizer(n.parameters(), **OPT))
        m = train_step(state, x, y, min_kept=MIN_KEPT, grad_clip=clip)
        out.append((n.state_dict(), m))
    assert len(norms) == 1 and norms[0] < 1e9
    (a, ma), (b, mb) = out
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_optimizer_matches_optax():
    """SGD + momentum + weight decay on every tensor + the staircase
    learning rate against optax on the same gradients: three epochs of two
    updates each, so the rate decays twice."""
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "scale": (4,), "bias": (4,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(6)]
    tx = jax_make_optimizer(lr=0.1, steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    state = TrainState(torch.nn.Module(), make_optimizer(
        list(tp.values()), lr=0.1, steps_per_epoch=2))
    for k, g in enumerate(grads):
        upd, jopt = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                              jopt, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in tp.items():
            p.grad = torch.from_numpy(g[n])
        set_learning_rate(state.optimizer, k)
        state.optimizer.step()
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
            0.1 * 0.992 ** (k // 2), rel=1e-12)
        for n, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-7)


def test_training_after_an_inference_mode_forward():
    """The resize matrices are cached per shape; one first made under
    torch.inference_mode (an evaluation) must still serve a training
    forward's backward at the same shape."""
    net = DerivedNet(student_plan())
    x = torch.from_numpy(_batches(3, 1)[0][0])
    with torch.inference_mode():
        net(x)
    net.train()
    p8, p16, p32 = net(x)
    (p8.mean() + p16.mean() + p32.mean()).backward()
    assert net.stem[0].conv[0].weight.grad is not None
