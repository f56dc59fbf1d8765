"""The port's search engine (fasterseg_tpu_torch/search/loop.py) and its
driver on the CPU, at tests/test_search.py's tiny configuration (5 layers,
Fch 8, batch 2 at 64x128, a stand-in latency table), with the JAX package
as the oracle where it can be one.

* The forwards of a step in the reference's order.
* `save` writes arch_{idx}.npz that the JAX package reads and decodes to
  the genotypes the port decodes, each arch with its own metrics.
* `run_search` for one epoch of two steps, pretrain and search (the JAX
  package's own engine tests of this are `slow`).
* Resume: two epochs unbroken equal one epoch, save, restore and one more,
  bit for bit (weights, BN statistics, both optimizers, arch parameters,
  controller, epoch); `load_weights` carries the weights.
* `slow`: one weight step (pretrain and search) and one arch step against
  the JAX package's SearchEngine from the same state on JAX's draws.

bf16 compute, genotype plots and `--bf16` are held in
tests/test_torch_search_bf16.py and tests/test_torch_plotting.py.
"""

import os

import jax
import numpy as np
import pytest
import torch

from fasterseg_tpu.core.genotype import ArchParams as JaxArchParams
from fasterseg_tpu.core.genotype import decode_network as jax_decode
from fasterseg_tpu_torch.core.genotype import decode_network
from fasterseg_tpu_torch.data import SyntheticDataset
from fasterseg_tpu_torch.search import (SearchEngine, forward_plan,
                                        run_search)

from _torch_search_common import (HW, WML, few_threads, jax_ratio_noise,
                                  port_lut, standin_ms, tiny_configs)


@pytest.mark.parametrize("pretrain,num_widths,want", [
    # loop.py:181-197: one forward per arch in search, then the sandwich
    # (max, min; + random, random in pretrain) on the last arch, or arch 0
    # in pretrain; a single width runs one max forward in pretrain
    (False, 5, [(0, "max"), (1, "arch_ratio"), (1, "max"), (1, "min")]),
    (True, 5, [(0, "max"), (0, "min"), (0, "random"), (0, "random")]),
    (False, 1, [(0, "max"), (1, "arch_ratio")]),
    (True, 1, [(0, "max")]),
])
def test_forward_plan_is_the_reference_order(pretrain, num_widths, want):
    assert forward_plan(2, ("max", "arch_ratio"), num_widths,
                        pretrain) == want


@pytest.fixture(scope="module")
def val_dataset():
    return SyntheticDataset(length=2, hw=HW, num_classes=19)


def test_arch_npz_is_read_by_jax(tmp_path):
    cfg, _ = tiny_configs(pretrain=False)
    engine = SearchEngine(cfg, lut=port_lut(), device="cpu")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for ap in engine.arch_params.values():
            for t in ap.tensors():
                t.copy_(torch.randn(t.shape, generator=g))
    metrics = {0: {"mIoU02": 0.5, "latency02": 10.0, "mIoU12": 0.4,
                   "latency12": 11.0},
               1: {"mIoU02": 0.3, "latency02": 6.0, "mIoU12": 0.2,
                   "latency12": 7.0}}
    engine.save(str(tmp_path), epoch=3, metrics=metrics)
    for idx in (0, 1):
        path = str(tmp_path / f"arch_{idx}.npz")
        assert os.path.exists(tmp_path / f"arch_{idx}_3.npz")
        d = np.load(path)
        for k, v in metrics[idx].items():
            assert float(d[k]) == v
        ours = engine.numpy_arch(idx)
        theirs = JaxArchParams.from_npz(path)
        for a, b in zip(ours.alphas + ours.betas[1:] + ours.ratios,
                        theirs.alphas + theirs.betas[1:] + theirs.ratios):
            np.testing.assert_array_equal(a, b)
        assert d["alpha0"].shape == (5, 5)
        skip = idx == 0
        want = jax_decode(theirs, WML, cfg.layers, ignore_skip=skip)
        got = decode_network(ours, WML, cfg.layers, ignore_skip=skip)
        assert set(got) == set(want)
        for last in want:
            assert tuple(got[last].ops) == tuple(want[last].ops)
            assert tuple(got[last].path) == tuple(want[last].path)
            np.testing.assert_allclose(got[last].widths, want[last].widths)


def _arch_moved(engine, idx):
    return [float((t - 1e-3).abs().max()) > 0
            for t in engine.arch_params[idx].tensors()]


def test_run_search_pretrain_smoke(val_dataset, tmp_path):
    cfg, _ = tiny_configs(pretrain=True)
    engine = run_search(cfg, val_dataset=val_dataset, epochs=1, niters=2,
                        max_eval_items=1, save_dir=str(tmp_path),
                        lut=port_lut(), device="cpu")
    m = engine.metrics_log[-1]
    assert len(m["losses"]) == 2 and all(np.isfinite(m["losses"]))
    assert engine.step == 2
    # the arch parameters do not move in pretrain
    for idx in (0, 1):
        assert not any(_arch_moved(engine, idx))
    assert os.path.exists(tmp_path / "arch_0.npz")
    assert os.path.exists(tmp_path / "metrics.jsonl")


def test_run_search_search_smoke(val_dataset, tmp_path):
    cfg, _ = tiny_configs(pretrain=False)
    engine = run_search(cfg, val_dataset=val_dataset, epochs=1, niters=2,
                        max_eval_items=1, save_dir=str(tmp_path),
                        lut=port_lut(), device="cpu")
    m = engine.metrics_log[-1]
    assert np.isfinite(m["loss"]) and np.isfinite(m["loss_arch"])
    assert m["latency_supernet_ms"] > 0 and m["loss_latency"] > 0
    # the student's every alpha, beta and ratio tensor moved; the teacher
    # (zero latency weight) still gets task-loss gradients for alpha/beta
    assert all(_arch_moved(engine, 1))
    assert all(_arch_moved(engine, 0)[:5])
    fps0, fps1 = engine.arch_fps(1)
    assert fps0 > 0 and fps1 > 0
    # the band (fps_min 1e9) forces one doubling of the student's weight
    assert engine.controller.weights == [0.0, pytest.approx(2e-2)]
    d = np.load(tmp_path / "arch_1.npz")
    assert d["alpha0"].shape == (5, 5)
    assert "mIoU02" in d and "latency12" in d
    with open(tmp_path / "metrics.jsonl") as f:
        tags = {line.split('"tag": "')[1].split('"')[0] for line in f}
    assert {"train/loss_arch", "arch/fps0_student",
            "mIoU/val_student_8s_32s"} <= tags


def _snapshot(engine):
    opt = engine.optimizer.state_dict()
    aopt = engine.arch_optimizer.state_dict()
    return {
        "model": {k: v.clone() for k, v in engine.model.state_dict().items()},
        "momentum": [opt["state"][i]["momentum_buffer"].clone()
                     for i in sorted(opt["state"])],
        "adam": [(s["exp_avg"].clone(), s["exp_avg_sq"].clone(),
                  float(s["step"])) for _, s in sorted(aopt["state"].items())],
        "arch": [t.detach().clone() for idx in sorted(engine.arch_params)
                 for t in engine.arch_params[idx].tensors()],
        "controller": list(engine.controller.weights),
        "step": engine.step,
        "lr": opt["param_groups"][0]["lr"]}


def test_resume_is_bit_exact(val_dataset, tmp_path):
    cfg, _ = tiny_configs(pretrain=False)
    kw = dict(val_dataset=val_dataset, niters=1, max_eval_items=1,
              lut=port_lut(), device="cpu")
    unbroken = _snapshot(run_search(cfg, epochs=2, **kw))
    run_search(cfg, epochs=1, save_dir=str(tmp_path), **kw)
    resumed_engine = run_search(cfg, epochs=2, save_dir=str(tmp_path),
                                resume=True, **kw)
    resumed = _snapshot(resumed_engine)
    assert resumed["step"] == unbroken["step"] == 2
    assert resumed["controller"] == unbroken["controller"] == [0.0, 4e-2]
    assert resumed["lr"] == unbroken["lr"]
    for k, v in unbroken["model"].items():
        assert torch.equal(v, resumed["model"][k]), k
    for name in ("momentum", "arch"):
        assert len(unbroken[name]) == len(resumed[name]) > 0
        for a, b in zip(unbroken[name], resumed[name]):
            assert torch.equal(a, b), name
    for (m1, v1, s1), (m2, v2, s2) in zip(unbroken["adam"], resumed["adam"]):
        assert torch.equal(m1, m2) and torch.equal(v1, v2) and s1 == s2 == 2

    fresh = SearchEngine(cfg, lut=port_lut(), device="cpu")
    res = fresh.load_weights(str(tmp_path))
    assert not res.missing and not res.mismatched
    for k, v in resumed_engine.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


# ---------------------------------------------------------------- slow tier


@pytest.fixture(scope="module")
def engines():
    """The JAX package's SearchEngine (pretrain and search) and the port's,
    from the same weights (the JAX init carried over by
    `from_jax_supernet_variables`) and the same stand-in latency table."""
    from fasterseg_tpu.latency import LatencyLUT as JaxLUT
    from fasterseg_tpu.search import SearchEngine as JaxEngine
    from fasterseg_tpu_torch.utils.weights import from_jax_supernet_variables
    out = {}
    for pretrain in (True, False):
        cfg, jcfg = tiny_configs(pretrain=pretrain)
        jax_lut = JaxLUT(provider=standin_ms)
        # the JAX engine replaces an empty LUT by its TPU cost model
        # (`lut or ...`, loop.py:106), so this one starts with an entry
        jax_lut.get("ff_H1_W1_C1")
        jax_engine = JaxEngine(jcfg, lut=jax_lut)
        engine = SearchEngine(cfg, lut=port_lut(), device="cpu")
        variables = jax.tree.map(np.asarray, {
            "params": jax_engine.state.params,
            "batch_stats": jax_engine.state.batch_stats})
        sd = from_jax_supernet_variables(variables, cfg)
        missing, unexpected = engine.model.load_state_dict(sd, strict=False)
        assert not unexpected and all(k.endswith("num_batches_tracked")
                                      for k in missing)
        out[pretrain] = (jax_engine, engine, sd)
    return out


def _batch():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, *HW, 3)).astype(np.float32)
    y = rng.integers(0, 19, (2, HW[0] // 8, HW[1] // 8)).astype(np.int32)
    y[1, :2, :5] = 255
    return x, y


def _forward_noise(engine, pretrain, key):
    """JAX's draws for the forwards of supernet_loss(key) (loop.py:150-197),
    in the port's forward order."""
    n_arch = len(engine.arch_params)
    keys = jax.random.split(key, n_arch + 4)
    noise = []
    for i, (idx, mode) in enumerate(engine.forwards(pretrain)):
        k = keys[idx] if (not pretrain and i < n_arch) else \
            keys[n_arch + i - (0 if pretrain else n_arch)]
        ratios = [t.detach().numpy() for t in engine.arch_params[idx].ratios]
        noise.append(jax_ratio_noise(k, ratios, mode, engine.nw))
    return noise


def _float64_copy(engine):
    """The engine's state in float64 (a reference for fp32 rounding)."""
    import copy
    e = copy.deepcopy(engine)
    e.model.double()
    for ap in e.arch_params.values():
        for t in ap.tensors():
            t.data = t.data.double()
    e.tables = {k: v.double() for k, v in e.tables.items()}
    return e


def _f64(noise):
    return [[None if n is None else (n.double() if n.is_floating_point()
                                     else n) for n in f] for f in noise]


def _update_errors(states, old, keys):
    """Per pair of states, the largest |a - b| of a tensor over the largest
    step of the float64 update in that tensor, and its tensor."""
    out = {}
    ref = states["port64"]
    for a, b in (("port32", "jax32"), ("port32", "port64"),
                 ("jax32", "port64")):
        worst = (0.0, "")
        for k in keys:
            step = float((ref[k] - old[k].double()).abs().max())
            err = float((states[a][k].double() - states[b][k].double())
                        .abs().max())
            worst = max(worst, (err / max(step, 1e-30), k))
        out[f"{a}_vs_{b}"] = worst
    return out


@pytest.mark.slow
@pytest.mark.parametrize("pretrain", [True, False])
def test_weight_step_matches_jax_engine(engines, pretrain):
    """One weight step from the shared state on JAX's draws, and the port's
    step in float64 as the reference for fp32 rounding. Bars: the loss
    within 1e-6 relative of JAX's and of float64's; every parameter of the
    port's fp32 step within 15 % of its tensor's largest float64 step from
    JAX's fp32 step, and JAX's within 10 % from float64 (the port's
    function); BN statistics within 1e-4 + 1e-4 |ref| of JAX's. Readings on
    the CPU in fp32 (% of the step): pretrain port-JAX 7.0, port-float64 4.9,
    JAX-float64 7.0; search 10.6, 10.6 and 4.2 (the port's fp32 rounding of
    one zoomed down conv's weight gradient)."""
    from fasterseg_tpu_torch.utils.weights import from_jax_supernet_variables
    jax_engine, engine, sd0 = engines[pretrain]
    engine.model.load_state_dict(sd0, strict=False)
    x, y = _batch()
    rng = jax.random.PRNGKey(21)
    cfg = engine.config
    noise = _forward_noise(engine, pretrain, rng)
    old = {k: v.clone() for k, v in engine.model.state_dict().items()}
    ref = _float64_copy(engine)
    loss64 = ref.weight_step(torch.from_numpy(x).double(),
                             torch.from_numpy(y), pretrain,
                             noise=_f64(noise))
    loss = engine.weight_step(torch.from_numpy(x), torch.from_numpy(y),
                              pretrain, noise=noise)
    state, jloss = jax_engine._weight_step(pretrain)(
        jax.tree.map(jax.numpy.array, jax_engine.state),
        jax_engine.arch_params, x, y, rng)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(loss64), rtol=1e-6)
    jax32 = from_jax_supernet_variables(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}), cfg)
    states = {"port32": engine.model.state_dict(), "jax32": jax32,
              "port64": ref.model.state_dict()}
    params = [k for k, _ in engine.model.named_parameters()]
    errors = _update_errors(states, old, params)
    print(f"pretrain={pretrain}: loss {float(loss)} (JAX {float(jloss)}, "
          f"float64 {float(loss64)}); parameter errors over the step: "
          f"{errors}")
    assert errors["port32_vs_jax32"][0] < 0.15, errors
    assert errors["jax32_vs_port64"][0] < 0.10, errors
    for k, v in jax32.items():
        if k not in params:
            np.testing.assert_allclose(states["port32"][k].numpy(),
                                       v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.slow
def test_arch_step_matches_jax_engine(engines):
    """One arch step from the shared state on JAX's draws: loss_arch,
    loss_latency and latency_supernet_ms within 1e-5 relative; the arch
    parameters after Adam's first update (lr * g / (|g| + eps), so the
    update's size does not depend on |g|) equal within 1e-6 but where the
    two gradients' signs differ, at most 2 % of the entries."""
    jax_engine, engine, sd0 = engines[False]
    engine.model.load_state_dict(sd0, strict=False)
    x, y = _batch()
    rng = jax.random.PRNGKey(22)
    k1, k2 = jax.random.split(rng)
    lat_keys = jax.random.split(k2, len(engine.arch_params))
    latency_noise = {
        idx: jax_ratio_noise(lat_keys[idx],
                             [t.detach().numpy() for t in ap.ratios],
                             engine.prun_modes[idx], engine.nw)
        for idx, ap in engine.arch_params.items()}
    old = [t.detach().clone() for idx in sorted(engine.arch_params)
           for t in engine.arch_params[idx].tensors()]
    got = engine.arch_step(torch.from_numpy(x), torch.from_numpy(y),
                           noise=_forward_noise(engine, False, k1),
                           latency_noise=latency_noise)
    lat_w = jax.numpy.asarray(jax_engine.controller.weights, np.float32)
    aps, _, _, am = jax_engine._arch_step()(
        jax.tree.map(jax.numpy.array, jax_engine.arch_params),
        jax.tree.map(jax.numpy.array, jax_engine.arch_opt_state),
        jax_engine.state.params, jax_engine.state.batch_stats, x, y, rng,
        lat_w)
    for k in ("loss_arch", "loss_latency", "latency_supernet_ms"):
        np.testing.assert_allclose(float(got[k]), float(am[k]), rtol=1e-5,
                                   err_msg=k)
    want = [np.asarray(t) for idx in sorted(aps) for t in
            list(aps[idx].alphas) + list(aps[idx].betas[1:])
            + list(aps[idx].ratios)]
    new = [t.detach() for idx in sorted(engine.arch_params)
           for t in engine.arch_params[idx].tensors()]
    flips = 0
    for n, o, w in zip(new, old, want):
        flips += int((~np.isclose(n.numpy(), w, rtol=0, atol=1e-6)).sum())
    total = sum(w.size for w in want)
    print(f"arch step: {dict((k, float(v)) for k, v in got.items())}; "
          f"{flips} of {total} arch entries differ by more than 1e-6")
    assert flips <= 0.02 * total
