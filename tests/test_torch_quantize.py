"""fasterseg_tpu_torch int8 PTQ (models/quantize.py) against the JAX
package's models/quantize.py on the CPU.

The same seeded variables (`_both`, tests/test_torch_weights.py: the JAX
student at 64x128 after one train-mode step) are quantized by both packages:
the int8 values, scales and exempt weights must be equal bit for bit, and
the fp32 int8 network's logits within the derived-net parity bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasterseg_tpu.models import quantize as jq
import fasterseg_tpu_torch.models.quantize as tq
from fasterseg_tpu_torch.models import InferenceRunner
from fasterseg_tpu_torch.utils import checkpoint
from fasterseg_tpu_torch.utils import from_jax_quantized, from_jax_variables
from _torch_search_common import few_threads  # noqa: F401 (autouse)
from test_torch_weights import HW, _both

NUM_CLASSES = 19   # the student plan of _both


@pytest.fixture(scope="module")
def both():
    return _both("student")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_quantize_weight_equals_jax_bit_for_bit(both):
    """Each JAX conv kernel (HWIO): the port's arithmetic gives the JAX
    package's int8 values and scales, and exempts the same kernels."""
    _, _, variables, _, _, _ = both
    qtree, stree = jq.quantize_params(variables["params"],
                                      num_classes=NUM_CLASSES)
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    q_leaves = jax.tree_util.tree_leaves(_np_tree(qtree))
    s_leaves = jax.tree_util.tree_leaves(_np_tree(stree))
    n_int8 = n_exempt = 0
    for (path, w), q, s in zip(flat, q_leaves, s_leaves):
        if not (path[-1].key == "kernel" and np.ndim(w) == 4):
            continue
        w = np.asarray(w)
        oihw = np.transpose(w, (3, 2, 0, 1))
        if tq.is_exempt(oihw, NUM_CLASSES):
            assert q.dtype != np.int8, path
            n_exempt += 1
            continue
        assert q.dtype == np.int8, path
        got_q, got_s = tq.quantize_weight(w)
        np.testing.assert_array_equal(got_q, q)
        np.testing.assert_array_equal(got_s, s)
        assert got_s.dtype == np.float32 and got_s.shape == (1, 1, 1,
                                                              w.shape[3])
        n_int8 += 1
    assert n_int8 > 10 and n_exempt == 4   # stem entry, three classifiers


def test_from_jax_quantized_equals_port_quantization(both):
    """The JAX package's qvars carried across (HWIO -> OIHW, scales
    (1,1,1,O) -> (O,1,1,1)) equal the port's own quantization of the same
    weights: the same int8 keys, values, scales and pass-through entries."""
    _, _, variables, tplan, _, _ = both
    qtree, stree = jq.quantize_params(variables["params"],
                                      num_classes=NUM_CLASSES)
    carried = from_jax_quantized(tplan, {
        "params_q": _np_tree(qtree), "params_scale": _np_tree(stree),
        "batch_stats": variables["batch_stats"]})
    q, scales = tq.quantize_params(from_jax_variables(tplan, variables),
                                   num_classes=NUM_CLASSES)
    assert set(carried["params_scale"]) == set(scales)
    assert set(carried["params_q"]) == set(q)
    for k, v in q.items():
        assert carried["params_q"][k].dtype == v.dtype, k
        assert torch.equal(carried["params_q"][k], v), k
    for k, s in scales.items():
        assert s.shape == (q[k].shape[0], 1, 1, 1) and s.dtype == torch.float32
        assert torch.equal(carried["params_scale"][k], s), k
    exempt = {k for k, v in q.items() if v.ndim == 4 and k not in scales}
    assert exempt == {"stem.0.conv.0.weight", "heads8.conv_1x1.weight",
                      "heads16.conv_1x1.weight", "heads32.conv_1x1.weight"}


def test_mse_clip_never_worse_than_absmax(both):
    """Per output channel the searched clip reconstructs at least as well
    (in MSE) as plain absmax/127; every other entry passes through
    unchanged (tests/test_quantize.py:17-43)."""
    _, _, _, _, net, _ = both
    sd = net.state_dict()
    q, scales = tq.quantize_params(sd, num_classes=NUM_CLASSES)
    deq = tq.dequantize_params(q, scales, torch.float32)
    assert len(scales) > 10
    for k, a in sd.items():
        # float32 numpy, as the JAX test computes it
        a, b = a.numpy(), deq[k].numpy()
        if k in scales:
            step = np.abs(a).max(axis=(1, 2, 3), keepdims=True) / 127.0
            step = np.where(step > 0, step, 1.0)
            plain = np.clip(np.round(a / step), -127, 127) * step - a
            mse_plain = (plain ** 2).sum(axis=(1, 2, 3))
            mse_ours = ((b - a) ** 2).sum(axis=(1, 2, 3))
            assert np.all(mse_ours <= mse_plain + 1e-10), k
        else:
            np.testing.assert_array_equal(a, b)


def test_quantized_runner_fp32_matches_jax(both):
    """QuantizedRunner in fp32 on the plain path against the JAX
    QuantizedRunner's plain flax network on the same seeded input: the
    derived-net parity bar, 2e-4."""
    jplan, _, variables, tplan, net, x = both
    jqvars, jrunner = jq.quantize_variables(jplan, variables,
                                            dtype=jnp.float32,
                                            fast_stem_enabled=False,
                                            fast_body_enabled=False)
    want = np.asarray(jax.jit(jrunner.logits_fn)(jqvars, jnp.asarray(x)))
    _, runner = tq.quantize_variables(tplan, net, dtype=torch.float32,
                                      device="cpu", fast_stem_enabled=False)
    got = runner.logits(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, *HW, NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def jax_test_case():
    """tests/test_quantize.py's own case: the JAX student's fresh bf16 init
    at 64x128 and its bf16 input, carried to the port."""
    from fasterseg_tpu.models import create_derived
    from fasterseg_tpu_torch.models import DerivedNet, student_plan
    from fasterseg_tpu_torch.utils import load_reference_state_dict
    from test_torch_weights import PLANS
    jplan, tplan = PLANS["student"][0](), student_plan()
    _, variables = create_derived(jplan, jax.random.PRNGKey(0),
                                  input_hw=HW, dtype=jnp.bfloat16)
    net = DerivedNet(tplan)
    load_reference_state_dict(net, from_jax_variables(tplan,
                                                      _np_tree(variables)))
    x = jax.random.normal(jax.random.PRNGKey(1), (1, *HW, 3), jnp.bfloat16)
    return tplan, net, torch.from_numpy(np.asarray(x, np.float32))


def test_quantized_classmap_agrees_with_bf16(jax_test_case):
    """The int8 runner's bf16 kernel path (plain versions on the CPU)
    against the bf16 InferenceRunner on the JAX test's case: class maps
    agree on >= 97 % of pixels and logits by < 0.05 on average
    (tests/test_quantize.py:46-67). Random weights have small argmax
    margins: on `_both`'s weights the JAX package's own int8 path agrees
    with its bf16 path on 96.0 %."""
    tplan, net, x = jax_test_case
    runner = InferenceRunner(tplan, net, dtype=torch.bfloat16, device="cpu")
    _, qrunner = tq.quantize_variables(tplan, net, device="cpu")
    agree = (runner.classmap(x) == qrunner.classmap(x)).float().mean()
    assert agree.item() >= 0.97
    diff = (runner.logits(x).float() - qrunner.logits(x).float()).abs()
    assert diff.mean().item() < 0.05


def test_qvars_survive_checkpoint(both, tmp_path):
    _, _, _, tplan, net, _ = both
    qvars, _ = tq.quantize_variables(tplan, net, device="cpu")
    path = str(tmp_path / "int8_ckpt")
    checkpoint.save(path, qvars)
    back = checkpoint.load(path)
    assert set(back) == {"params_q", "params_scale"}
    for part in ("params_q", "params_scale"):
        assert set(back[part]) == set(qvars[part])
        for k, v in qvars[part].items():
            assert back[part][k].dtype == v.dtype, k
            assert torch.equal(back[part][k], v), k
    assert sum(v.dtype == torch.int8 for v in back["params_q"].values()) \
        == len(qvars["params_scale"]) > 10


@pytest.mark.parametrize("port,port_ref,jax_,jax_ref,rule,met", [
    (99.90, 99.92, 99.85, 99.86, "jax_floor", True),       # floor met
    (99.80, 99.92, 99.90, 99.92, "jax_floor", False),      # JAX meets it
    (99.657, 99.847, 99.649, 99.836, "jax_arithmetic_less_0.05pp", True),
    (99.59, 99.847, 99.649, 99.836, "jax_arithmetic_less_0.05pp", False),
])
def test_int8_agreement_bar(port, port_ref, jax_, jax_ref, rule, met):
    """The held int8 agreement bar: the JAX acceptance's floor, and where
    the JAX arithmetic misses it on the same weights too, the JAX
    arithmetic's agreement less 0.05 pp (the 8-epoch study's readings are
    the third case)."""
    from fasterseg_tpu_torch.cli.int8_check import agreement_bar
    result = {"classmap_agreement_pct": port,
              "bf16_vs_f32_agreement_pct": port_ref,
              "mIoU_delta_points": 0.0,
              "jax_arithmetic": {"classmap_agreement_pct": jax_,
                                 "bf16_vs_f32_agreement_pct": jax_ref,
                                 "mIoU_delta_points": 0.0}}
    bar = agreement_bar(result)
    assert bar["rule"] == rule and bar["met"] == met, bar
    if rule != "jax_floor":
        assert bar["floor_pct"] == pytest.approx(jax_ - 0.05)
