"""The port's bf16 search compute (`SearchConfig.compute_dtype="bfloat16"`:
parameters, optimizer states, BN statistics and arch parameters fp32, the
supernet computing in bf16) against the JAX package's, on the CPU, at
tests/test_search.py's tiny configuration (5 layers, Fch 8, batch 2 at
64x128).

Where the rounding is deterministic (eval-mode BN, fixed widths and mixing
weights, one bf16 input), the port must round to bf16 where the JAX package
does:

* each op of the supernet (the stem, three cells with their alpha-and-gate
  mixing, a head with its biased 1x1 conv, the resizes, the beta mix)
  returns JAX's bf16 output bit for bit on a share of elements (OP_BARS:
  1.0 for one-product ops, 0.99 for cells and heads, 0.95 for the stem)
  that the same op computed in fp32 and rounded once misses, and so does
  the op with its own rounding moved (a planted fault: the mixing weight or
  the beta row left fp32, the bias fused into the conv);
* the whole eval forward's logits are bit-equal to JAX's on at least 0.65
  of elements and within 3/4 of the fp32 forward's distance to them, bars
  that the fp32 forward misses (one JAX supernet compile, ~20 s).

One training step, from one state (the JAX bf16 engine's init carried over
by `from_jax_supernet_variables`) on JAX's draws and tests/
test_torch_search_engine.py's batch: a pretrain weight step (the sandwich
forwards) in tier 1 (one JAX step compile, ~130 s cold), a search weight
step and an arch step in the `slow` tier (~260 and ~195 s cold; with them
in tier 1, the whole tier's six workers on an 8-core CPU host took 1014 s
of its 1470 s limit). There train-mode BN over few values turns the ops'
rare one-ulp differences into the whole of bf16's noise, so the port's
step lies about as far from JAX's bf16 step as either lies from its fp32
step; an fp32 step would pass these bars, which is why the rounding points
are held above. The bars come from the JAX package's own bf16-vs-fp32
spread of the same steps, measured before this file held the port to
anything and written to tests/_torch_bf16_spread.py by
tests/_torch_jax_bf16_spread.py (for each step: the loss's |l16 - l32| /
|l32|, and for each moved tensor the update distance ||d16 - d32|| /
||d32||, the size ratio ||d16|| / ||d32|| and the cosine between d16 and
d32). The port's step moves the tensors JAX's bf16 step moves, and,
against JAX's bf16 step (BAR = 2):

* the loss within BAR times the largest of the three steps' loss spreads;
* the median and the 90th percentile of the tensors' update distances
  (||d_port - d_jax16|| / ||d_jax16||) within BAR times those of the
  step's spread, and every tensor within BAR times the step's largest;
* the median size ratio ||d_port|| / ||d_jax16|| within [1/BAR, BAR];
* the median cosine between d_port and d_jax16 at least 1/BAR of the
  median cosine of JAX's own d16 and d32.

Each step test also plants three faults in the port's update (shrunk a
thousandfold, negated, turned to a random direction of its size) and
requires each to miss a bar. A bar per tensor at twice that tensor's own
spread, as first written, is missed: one sample of JAX's spread for a
tensor can be small by chance (the first head's bias: 0.017, where the
port's own bf16-vs-fp32 spread is 0.075).

Also: the fp32 path is unchanged bit for bit (a step with the former fp32
formulas patched in, as the reference); `cli/train_search --bf16` runs a
step.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fasterseg_tpu_torch.search import SearchEngine
from fasterseg_tpu_torch.utils.weights import from_jax_supernet_variables

import _torch_jax_bf16_spread as spread_run
from _torch_bf16_spread import SPREAD
from _torch_search_common import (few_threads, jax_ratio_noise,  # noqa
                                  port_lut, tiny_configs)
from test_torch_search_engine import _batch, _forward_noise

BAR = 2.0        # times the JAX package's own bf16-vs-fp32 spread


@pytest.fixture(scope="module")
def engines():
    """The JAX package's bf16 search engine and the port's, from the same
    weights and statistics."""
    jax_engine, jcfg = spread_run.jax_engine("bfloat16")
    cfg, _ = tiny_configs(pretrain=False, compute_dtype="bfloat16")
    engine = SearchEngine(cfg, lut=port_lut(), device="cpu")
    sd = from_jax_supernet_variables(jax.tree.map(np.asarray, {
        "params": jax_engine.state.params,
        "batch_stats": jax_engine.state.batch_stats}), cfg)
    missing, unexpected = engine.model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked")
                                  for k in missing)
    return jax_engine, engine


def _floats(state):
    return {k: v.detach().double() for k, v in state.items()
            if v.is_floating_point()}


def _arch(engine):
    return {f"arch{idx}.{name}": t.detach().double() for idx, ap in
            sorted(engine.arch_params.items()) for name, t in zip(
                spread_run.ARCH_NAMES, ap.tensors())}


def _misses(name, loss, jloss, delta, jdelta):
    """The bars of the step `name` that the port's step misses, against
    JAX's bf16 step (`delta`, `jdelta`: each moved tensor's update), and
    the readings."""
    s = SPREAD[name]
    loss_bar = BAR * max(v["loss"] for v in SPREAD.values())
    keys = sorted(jdelta)
    dist = np.array([spread_run.relative(delta[k], jdelta[k]) for k in keys])
    size, cos = np.array([spread_run.size_and_cosine(delta[k], jdelta[k])
                          for k in keys]).T
    theirs = np.array([s["tensors"][k] for k in keys])
    readings = {"loss_rel": abs(loss - jloss) / abs(jloss),
                "size_p50": float(np.median(size)),
                "cos_p50": (float(np.median(cos)),
                            float(np.median([s["cos"][k] for k in keys])))}
    misses = []
    if readings["loss_rel"] > loss_bar:
        misses.append("loss")
    for q in (50, 90, 100):
        got, spread = readings[f"dist_p{q}"] = (
            float(np.percentile(dist, q)), float(np.percentile(theirs, q)))
        if got > BAR * spread:
            misses.append(f"dist_p{q}")
    if not 1 / BAR <= readings["size_p50"] <= BAR:
        misses.append("size")
    if readings["cos_p50"][0] < readings["cos_p50"][1] / BAR:
        misses.append("cos")
    return misses, readings


def _hold(name, loss, jloss, before, after, jbefore, jafter):
    """The port's step against JAX's bf16 step at the spread's bars, and
    three planted faults that each must miss one: the update shrunk a
    thousandfold, negated, and turned to a random direction of its size."""
    moved = {k for k in jafter if not torch.equal(
        torch.as_tensor(jafter[k]), torch.as_tensor(jbefore[k]))}
    ours = {k for k in jafter if not torch.equal(after[k], before[k])}
    assert ours == moved and moved <= set(SPREAD[name]["tensors"])
    jdelta = {k: np.asarray(jafter[k], np.float64)
              - np.asarray(jbefore[k], np.float64) for k in moved}
    delta = {k: (after[k] - before[k]).numpy() for k in moved}
    misses, readings = _misses(name, loss, jloss, delta, jdelta)
    print(f"{name}: {readings}")
    assert not misses, (misses, readings)
    rng = np.random.default_rng(0)

    def turned(d):
        r = rng.standard_normal(d.shape)
        return r * (np.linalg.norm(d) / np.linalg.norm(r))

    for fault, f in (("shrunk", lambda d: 1e-3 * d), ("negated", np.negative),
                     ("random direction", turned)):
        planted, readings = _misses(name, loss, jloss,
                                    {k: f(d) for k, d in delta.items()},
                                    jdelta)
        print(f"{name}, planted {fault}: misses {planted}")
        assert planted, (fault, readings)


def _weight_step(engines, pretrain):
    jax_engine, port = engines
    engine = copy.deepcopy(port)
    x, y = _batch()
    noise = _forward_noise(engine, pretrain,
                           jax.random.PRNGKey(spread_run.WEIGHT_KEY))
    before = _floats(engine.model.state_dict())
    loss = float(engine.weight_step(torch.from_numpy(x),
                                    torch.from_numpy(y), pretrain,
                                    noise=noise))
    after = _floats(engine.model.state_dict())
    assert all(p.dtype == torch.float32 for p in engine.model.parameters())
    jloss, jbefore, jafter = spread_run.weight_step(jax_engine, pretrain)
    return _hold("pretrain_weight" if pretrain else "search_weight", loss,
                 jloss, before, after, jbefore, jafter)


def test_pretrain_weight_step_matches_jax_bf16(engines):
    _weight_step(engines, True)


@pytest.mark.slow
def test_search_weight_step_matches_jax_bf16(engines):
    _weight_step(engines, False)


@pytest.mark.slow
def test_arch_step_matches_jax_bf16(engines):
    jax_engine, port = engines
    engine = copy.deepcopy(port)
    x, y = _batch()
    k1, k2 = jax.random.split(jax.random.PRNGKey(spread_run.ARCH_KEY))
    lat_keys = jax.random.split(k2, len(engine.arch_params))
    latency_noise = {
        idx: jax_ratio_noise(lat_keys[idx],
                             [t.detach().numpy() for t in ap.ratios],
                             engine.prun_modes[idx], engine.nw)
        for idx, ap in engine.arch_params.items()}
    before = _arch(engine)
    got = engine.arch_step(torch.from_numpy(x), torch.from_numpy(y),
                           noise=_forward_noise(engine, False, k1),
                           latency_noise=latency_noise)
    after = _arch(engine)
    assert all(t.dtype == torch.float32 for ap in engine.arch_params.values()
               for t in ap.tensors())
    jloss, jbefore, jafter = spread_run.arch_step(jax_engine)
    _hold("arch", float(got["loss_arch"]), jloss, before, after, jbefore,
          jafter)


# ---- the rounding points: each op and the forward against JAX's bf16

# the share of elements bit-equal to JAX's bf16 that each op must reach: a
# resize or the beta mix is one product (bit for bit); a cell or a head
# sums fp32-accumulated convs whose order differs, so one in several
# thousand elements lands one ulp apart (readings: cells 0.99978-0.99997,
# head 0.99949); the stem stacks five convs, each carrying the rare one-ulp
# difference of the one before (reading 0.976). The planted faults read
# 0.41-0.68 (fp32 rounded once) and 0.68-0.90 (a rounding moved).
OP_BARS = {"stem": 0.95, "cell_0_0": 0.99, "cell_1_1": 0.99,
           "cell_2_1": 0.99, "head": 0.99, "scale_by_2": 1.0,
           "scale_by_8": 1.0, "downsample_half": 1.0, "beta_mix": 1.0}


@pytest.fixture(scope="module")
def bf16_net():
    """A bf16 supernet in eval mode (BN rows and statistics randomised, the
    heads' 1x1 biases too: zero at init, they would hide where the bias is
    added) and the same weights as the JAX package's variables."""
    from fasterseg_tpu_torch.models.supernet import Supernet, init_supernet
    from _torch_search_common import (FCH, LAYERS, SHW, WML, randomize_bn_,
                                      to_jax_supernet_variables)
    model = randomize_bn_(init_supernet(Supernet(
        LAYERS, 19, FCH, WML, SHW, dtype=torch.bfloat16), 0), 1).eval()
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for heads in model.heads:
            for head in heads.values():
                b = head.conv_1x1.bias
                b.copy_(torch.randn(b.shape, generator=g))
    return model, to_jax_supernet_variables(model.state_dict(), LAYERS)


def _bf16_pair(rng, shape):
    """One bf16 input as a torch tensor and as a JAX array."""
    import jax.numpy as jnp
    t = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _share_equal(got, want) -> float:
    """The share of elements of `got` (torch) bit-equal to `want` (JAX)."""
    import jax.numpy as jnp
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    return float(np.mean(got.float().numpy() == w))


def _former_mixed(self, x, alpha, r_in, r_out):
    """SlimMixedOp with the fp32 mixing weight unrounded (one rounding of
    y * w, where the JAX package rounds w first)."""
    gate = r_in[1] * r_out[1]
    acc = None
    for k, op in enumerate(self.ops):
        y = op(x, r_in[0], r_out[0]) * (alpha[k] * gate)
        acc = y if acc is None else acc + y
    return acc


def _fused_bias_conv(self, x):
    """Conv with torch's fused bias (one rounding of conv + bias, where
    flax's bf16 Conv rounds the conv and then adds the bias)."""
    x = x.permute(0, 3, 1, 2)
    b = None if self.bias is None else self.bias.to(x.dtype)
    return self._conv_forward(x, self.weight.to(x.dtype), b).permute(
        0, 2, 3, 1)


def _op_case(case, model, variables, rng):
    """(the port's op on a bf16 input, JAX's bf16 op on it, and the planted
    faults' outputs: the op computed in fp32 and rounded once, and the
    op's own misplaced rounding where it has one)."""
    import jax.numpy as jnp
    from fasterseg_tpu.models.derived import Stem as JaxStem
    from fasterseg_tpu.models.supernet import SlimCell as JaxCell
    from fasterseg_tpu.ops import resize as jax_resize
    from fasterseg_tpu.ops.seg_heads import Head as JaxHead
    from fasterseg_tpu_torch.models import supernet
    from fasterseg_tpu_torch.ops import conv, resize
    from _torch_search_common import FCH, SHW, WML
    bf = jnp.bfloat16
    sub = lambda name: {c: variables[c][name] for c in variables
                        if name in variables[c]}
    fp32 = lambda f, x: f(x.float()).to(torch.bfloat16)
    if case == "stem":
        x, jx = _bf16_pair(rng, (2, 64, 128, 3))
        port = model.stems[1]
        return port(x), JaxStem(FCH, SHW[1][0], dtype=bf).apply(
            sub("stem1"), jx, False), {"fp32": lambda: fp32(port, x)}
    if case == "head":
        port = model.heads[1]["head0"]
        x, jx = _bf16_pair(rng, (2, 16, 32, port.conv_3x3.conv.in_channels))
        return port(x), JaxHead(19, dtype=bf).apply(sub("head01"), jx,
                                                    False), {
            "fp32": lambda: fp32(port, x),
            "fused bias": lambda: _patched(conv.Conv, "forward",
                                           _fused_bias_conv, port, x)}
    if case.startswith("cell"):
        name = case[5:]
        cell = model.cells[name]
        c_in = next(cell.parameters()).shape[1]
        x, jx = _bf16_pair(rng, (2, 16, 32, c_in))
        alpha = torch.softmax(torch.from_numpy(
            rng.standard_normal(5).astype(np.float32)), -1)
        down = cell.down is not None
        r = [(torch.tensor(i), torch.tensor(s)) for i, s in
             ((2, 0.8125), (3, 0.6), (4, 0.9))][:3 if down else 2]
        r += [None] * (3 - len(r))
        jr = [None if t is None else tuple(jnp.asarray(v.numpy()) for v in t)
              for t in r]
        want = JaxCell(c_in, down=down, width_mult_list=WML,
                       dtype=bf).apply(sub(f"cell_{name}"), jx,
                                       jnp.asarray(alpha.numpy()), jr, False)
        run = lambda x: torch.cat([t.flatten() for t in cell(x, alpha, *r)
                                   if t is not None])
        return run(x), jnp.concatenate([t.ravel() for t in want
                                        if t is not None]), {
            "fp32": lambda: fp32(run, x),
            "mixing weight unrounded": lambda: _patched(
                supernet.SlimMixedOp, "forward", _former_mixed, run, x)}
    if case == "beta_mix":
        (a, ja), (b, jb) = (_bf16_pair(rng, (2, 8, 16, 16)) for _ in "ab")
        w = torch.softmax(torch.from_numpy(
            rng.standard_normal(2).astype(np.float32)), -1)
        want = jax.jit(lambda a, b, w: a * w[0].astype(a.dtype)
                       + b * w[1].astype(b.dtype))(ja, jb,
                                                   jnp.asarray(w.numpy()))
        return supernet.beta_mix(a, b, w), want, {
            "fp32": lambda: supernet.beta_mix(a.float(), b.float(),
                                              w).to(torch.bfloat16),
            "beta unrounded": lambda: a * w[0] + b * w[1]}
    factor = {"scale_by_2": 2, "scale_by_8": 8}.get(case)
    port, jax_op = ((lambda x: resize.scale_by(x, factor),
                     lambda x: jax_resize.scale_by(x, factor)) if factor
                    else (resize.downsample_half, jax_resize.downsample_half))
    x, jx = _bf16_pair(rng, (2, 16, 32, 19))
    return port(x), jax_op(jx), {"fp32": lambda: fp32(port, x)}


def _patched(owner, attr, value, fn, x):
    before = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        return fn(x)
    finally:
        setattr(owner, attr, before)


@pytest.mark.parametrize("case", sorted(OP_BARS))
def test_bf16_op_rounds_where_jax_does(bf16_net, case):
    """Each op of the bf16 supernet on a bf16 input (eval-mode BN, widths
    and mixing weights fixed) against the JAX package's bf16 op on the same
    input and weights: the share of output elements bit-equal to JAX's
    reaches OP_BARS[case], and the same op computed in fp32 and rounded
    once, or with its own rounding moved (the mixing weight or the beta row
    left fp32, the bias fused into the conv), misses that bar."""
    model, variables = bf16_net
    rng = np.random.default_rng(sorted(OP_BARS).index(case))
    with torch.no_grad():
        got, want, faults = _op_case(case, model, variables, rng)
        share = _share_equal(got, want)
        planted = {k: _share_equal(f(), want) for k, f in faults.items()}
    print(f"{case}: {share:.5f} bit-equal; planted faults {planted}")
    assert share >= OP_BARS[case], (case, share)
    for fault, s in planted.items():
        assert s < OP_BARS[case], (case, fault, s)


def test_bf16_forward_rounds_where_jax_does(bf16_net):
    """The whole eval-mode forward (arch 1, JAX's arch_ratio width draws,
    five heads upsampled x8) in bf16 against the JAX package's bf16
    forward on the same weights and input. One-ulp differences in a few
    conv outputs spread through five layers and the x8 upsample, so the
    logits are bit-equal on a share of elements only: that share at least
    0.65 [reading 0.752], which the fp32 forward's logits rounded to bf16
    miss [0.519]; and the relative L2 distance to JAX's bf16 logits within
    3/4 of the fp32 forward's [0.00167 against 0.00307]."""
    import jax.numpy as jnp
    from fasterseg_tpu.models.supernet import Supernet as JaxSupernet
    from fasterseg_tpu.search.gumbel import sample_ratios as jax_ratios
    from fasterseg_tpu_torch.search import sample_ratios
    from _torch_search_common import FCH, HW, LAYERS, SHW, WML
    from test_torch_search_supernet import _arch
    model, variables = bf16_net
    x = np.random.default_rng(0).standard_normal((2, *HW, 3)).astype(
        np.float32)
    jap, tap, ra = _arch(1, 11)
    key = jax.random.PRNGKey(4)
    jm = JaxSupernet(layers=LAYERS, num_classes=19, Fch=FCH,
                     width_mult_list=WML, stem_head_width=SHW,
                     dtype=jnp.bfloat16)
    want = jax.jit(lambda v, x, ap, r: jm.apply(
        v, x, 1, ap.alphas, ap.betas, r, train=False))(
            variables, x, jap, jax_ratios(key, jap.ratios, "arch_ratio", 5))
    want = jnp.concatenate([w.ravel() for w in want])
    ratios = sample_ratios(tap.ratios, "arch_ratio", 5,
                           noise=jax_ratio_noise(key, ra, "arch_ratio", 5))
    out = {}
    with torch.no_grad():
        for name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
            net = copy.deepcopy(model)
            net.dtype = dtype
            out[name] = torch.cat([p.flatten() for p in net(
                torch.from_numpy(x), 1, tap.alphas, tap.betas, ratios)])
    w64 = np.asarray(want.astype(jnp.float32), np.float64)
    rel = {k: spread_run.relative(v.double().numpy(), w64)
           for k, v in out.items()}
    share = {k: _share_equal(v.to(torch.bfloat16), want)
             for k, v in out.items()}
    print(f"forward: relative L2 {rel}; bit-equal {share}")
    assert out["bf16"].dtype == torch.bfloat16
    assert share["bf16"] >= 0.65 > share["fp32"], share
    assert rel["bf16"] <= 0.75 * rel["fp32"], rel


def test_fp32_path_is_unchanged_bit_for_bit(monkeypatch):
    """An fp32 engine's arch step and both weight steps equal those of the
    same engine run with the former fp32 forms (nn.Conv2d's own forward,
    the mixing weight unrounded), bit for bit."""
    import torch.nn as nn
    from fasterseg_tpu_torch.models import supernet
    from fasterseg_tpu_torch.ops import conv
    cfg, _ = tiny_configs(pretrain=False)
    base = SearchEngine(cfg, lut=port_lut(), device="cpu")
    assert base.model.dtype is None
    x, y = (torch.from_numpy(a) for a in _batch())

    def steps(engine):
        g = torch.Generator().manual_seed(5)
        am = engine.arch_step(x, y, g)
        losses = [engine.weight_step(x, y, p, g) for p in (True, False)]
        return ({**engine.model.state_dict(), **_arch(engine)},
                [*am.values(), *losses])

    now = steps(copy.deepcopy(base))

    def former_conv(self, x):
        return nn.Conv2d.forward(self, x.permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)

    def former_mixed(self, x, alpha, r_in, r_out):
        gate = r_in[1] * r_out[1]
        acc = None
        for k, op in enumerate(self.ops):
            y = op(x, r_in[0], r_out[0]) * (alpha[k] * gate)
            acc = y if acc is None else acc + y
        return acc

    monkeypatch.setattr(conv.Conv, "forward", former_conv)
    monkeypatch.setattr(supernet.SlimMixedOp, "forward", former_mixed)
    then = steps(copy.deepcopy(base))
    for k, v in then[0].items():
        assert torch.equal(now[0][k], v), k
    for a, b in zip(now[1], then[1]):
        assert torch.equal(a, b)


def test_bf16_supernet_computes_in_bf16_on_fp32_parameters():
    """Train-mode heads in bf16, eval-mode heads upsampled in bf16, the
    parameters, BN statistics and arch parameters fp32."""
    from fasterseg_tpu_torch.search import sample_ratios
    cfg, _ = tiny_configs(pretrain=False, compute_dtype="bfloat16")
    engine = SearchEngine(cfg, lut=port_lut(), device="cpu")
    model, ap = engine.model, engine.arch_params[1].detached()
    assert model.dtype == torch.bfloat16
    x = torch.randn((1, 64, 128, 3))
    ratios = sample_ratios(ap.ratios, "max", engine.nw)
    with torch.no_grad():
        for train, hw in ((True, (8, 16)), (False, (64, 128))):
            model.train(train)
            preds = model(x, 1, ap.alphas, ap.betas, ratios)
            assert len(preds) == 5
            for p in preds:
                assert p.dtype == torch.bfloat16
                assert p.shape == (1, *hw, 19)
                assert bool(torch.isfinite(p.float()).all())
    assert all(t.dtype == torch.float32 for t in model.state_dict().values()
               if t.is_floating_point())


def test_train_search_cli_bf16_runs_a_step(tmp_path, monkeypatch):
    """`--bf16` sets compute_dtype and the engine steps in bf16 (the
    validation set shrunk to one 64x128 image)."""
    import fasterseg_tpu_torch.search as search
    from fasterseg_tpu_torch.cli import train_search
    real, seen = search.run_search, {}

    def small_eval(cfg, **kw):
        cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
            cfg.eval, eval_height=64, eval_width=128))
        seen["engine"] = real(cfg, **{**kw, "max_eval_items": 1})
        return seen["engine"]

    monkeypatch.setattr(search, "run_search", small_eval)
    train_search.main(["--synthetic", "--bf16", "--pretrain", "--device",
                       "cpu", "--layers", "5", "--epochs", "1", "--niters",
                       "1", "--height", "64", "--width", "128",
                       "--batch-size", "2", "--save", str(tmp_path)])
    engine = seen["engine"]
    assert engine.config.compute_dtype == "bfloat16"
    assert engine.model.dtype == torch.bfloat16 and engine.step == 1
    assert np.isfinite(engine.metrics_log[-1]["loss"])
