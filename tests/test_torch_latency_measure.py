"""The port's latency measurement (fasterseg_tpu_torch/latency/measure.py,
cost_model.py) against the JAX package's on the CPU.

The provider's modules: for every key kind, the op the JAX
`measured_provider` builds (its flax module and variables, caught where it
hands them to its timer) and the port's serving route on the same weights
compute the same function (fp32, the parity bar of test_torch_parity.py).
The cost model equals `TpuCostModel` when given the TPU's constants. The
harnesses floor their slope; `calibrate` raises.
"""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasterseg_tpu_torch.latency import measure
from fasterseg_tpu_torch.latency.cost_model import H100CostModel
from fasterseg_tpu_torch.latency.measure import (build_key, graph_slope_ms,
                                                 measured_provider,
                                                 serving_route, time_fn)
from fasterseg_tpu_torch.utils import weights as tw
from _torch_search_common import few_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4   # tests/test_torch_parity.py:43

# every key kind the sweep asks for, at small maps: ops 0-4 at strides 1
# and 2 (op 0 at stride 1 is the identity skip; op 4 under its true name),
# ConvNorm with kernel 1 and 3 (the stem's Ci = 3 at stride 2), ff, and
# the head at both of its mid widths (Cin <= 256 and Cin // 2 above)
KEYS = [
    "FactorizedReduce_H16_W32_Cin16_Cout32_stride2",
    "FactorizedReduce_H16_W32_Cin24_Cout24_stride1",
    "BasicResidual1x_H16_W32_Cin16_Cout24_stride1_dilation1",
    "BasicResidual1x_H16_W32_Cin16_Cout48_stride2_dilation1",
    "BasicResidual_downup_1x_H16_W32_Cin16_Cout24_stride1_dilation1",
    "BasicResidual_downup_1x_H16_W32_Cin16_Cout48_stride2_dilation1",
    "BasicResidual2x_H16_W32_Cin16_Cout24_stride1_dilation1",
    "BasicResidual2x_H16_W32_Cin24_Cout48_stride2_dilation1",
    "BasicResidual_downup_2x_H16_W32_Cin16_Cout24_stride1_dilation1",
    "BasicResidual_downup_2x_H16_W32_Cin24_Cout48_stride2_dilation1",
    "ConvNorm_H16_W32_Cin40_Cout24_kernel1_stride1",
    "ConvNorm_H16_W32_Cin40_Cout24_kernel3_stride1",
    "ConvNorm_H32_W64_Cin3_Cout32_kernel3_stride2",
    "ff_H16_W32_C40",
    "head_H8_W16_Cin48_Cout19",
    "head_H8_W16_Cin288_Cout19",
]


def _jax_module(key, monkeypatch):
    """The flax module and variables the JAX provider builds for `key`
    (fp32), caught where it hands its forward to the timer."""
    import fasterseg_tpu.latency.measure as jm
    caught = {}

    def timer(fn, args, **kw):
        caught.update(inspect.getclosurevars(fn).nonlocals)
        return 1.0

    monkeypatch.setattr(jm, "slope_time_ms", timer)
    jm.measured_provider(dtype=jnp.float32, verbose=False)(key)
    return caught["module"], caught["variables"]


def _randomized(tree, rng, path=()):
    """Seeded random values of the same shapes: kernels scaled by fan-in,
    BN scale in [0.5, 1.5), biases and means N(0, 0.1^2), var in [0.5, 2)."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _randomized(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = np.shape(tree), path[-1]
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.standard_normal(shape) * (2.0 / fan_in) ** 0.5
    if name == "scale":
        return rng.random(shape) + 0.5
    if name == "var":
        return rng.random(shape) * 1.5 + 0.5
    return rng.standard_normal(shape) * 0.1


def _port_state(op, variables):
    """The JAX variables as the port module's state_dict."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd = {}
    if op.kind == "op":
        for tsub, fsub, kind in tw._OP_LAYOUTS[op.index]:
            if kind == "conv":
                tw._conv_into(sd, f"m.{tsub}", p[fsub])
            else:
                tw._bn_into(sd, f"m.{tsub}", p[fsub], s[fsub])
    elif op.kind == "ConvNorm":
        tw._convnorm_into(sd, "m", p, s)
    elif op.kind == "ff":
        tw._conv_into(sd, "m.conv_1x1.conv", p["conv_1x1"]["Conv_0"])
        tw._bn_into(sd, "m.conv_1x1.bn", p["conv_1x1"]["BatchNorm_0"],
                    s["conv_1x1"]["BatchNorm_0"])
    else:
        tw._head_into(sd, "m", p, s)
    return {k[2:]: v for k, v in sd.items()}


@pytest.mark.parametrize("key", KEYS)
def test_provider_route_matches_jax_module(key, monkeypatch):
    module, variables = _jax_module(key, monkeypatch)
    variables = jax.tree.map(np.asarray, dict(variables))
    rng = np.random.default_rng(0)
    op = build_key(key)
    x = rng.standard_normal(op.shape).astype(np.float32)
    route = None
    if op.module is not None:
        variables = _randomized(variables, rng)
        missing, unexpected = op.module.load_state_dict(
            _port_state(op, variables), strict=False)
        assert not unexpected
        assert all(k.endswith("num_batches_tracked") for k in missing)
        route = serving_route(op, "cpu", torch.float32)
    want = np.asarray(module.apply(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), variables),
        jnp.asarray(x), train=False))
    if route is None:      # the identity skip: nothing to run or time
        assert key.startswith("FactorizedReduce") and "stride1" in key
        np.testing.assert_array_equal(want, x)
        assert measured_provider(device="cpu", verbose=False)(key) == 1e-3
        return
    with torch.inference_mode():
        got = route(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_provider_alias_key_builds_the_aliased_op():
    """Under the reference's alias, op 4's key names BasicResidual2x: it
    builds op 3, as the JAX provider does (measure.py:178)."""
    op = build_key("BasicResidual2x_H16_W32_Cin16_Cout24_stride1_dilation1")
    assert op.kind == "op" and op.index == 3
    assert build_key("BasicResidual_downup_2x_H16_W32_Cin16_Cout24_stride1"
                     "_dilation1").index == 4
    with pytest.raises(KeyError):
        build_key("ConvNorm_H16_W32_Cin16_Cout24_kernel5_stride1")


def test_cpu_provider_and_slopes_are_floored():
    ms = measured_provider(device="cpu", n1=1, n2=2, reps=1, verbose=False)(
        "BasicResidual1x_H8_W16_Cin16_Cout16_stride1_dilation1")
    assert np.isfinite(ms) and ms >= 1e-3
    # a call that does nothing: the slope is noise around 0, floored
    for _ in range(3):
        slope, spread, kind = graph_slope_ms(lambda: None, n1=1, n2=3,
                                             reps=3, floor_ms=1e-3,
                                             device="cpu")
        assert slope >= 1e-3 and kind == "raw_minmax"
    assert graph_slope_ms(lambda: None, reps=7, device="cpu")[2] == "trimmed"
    with pytest.raises(ValueError):
        graph_slope_ms(lambda: None, n1=4, n2=4, device="cpu")
    assert time_fn(lambda: torch.ones(8).sum(), warmup=1, min_seconds=0.01,
                   device="cpu") > 0


def test_entry_points_default_to_the_card():
    for fn in (measured_provider, graph_slope_ms, time_fn, serving_route,
               H100CostModel.calibrate):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            measured_provider()


def test_cost_model_equals_tpu_model_with_its_constants():
    from fasterseg_tpu.latency.cost_model import TpuCostModel
    ref = TpuCostModel()
    model = H100CostModel(peak_tflops=ref.peak_tflops,
                          hbm_gbps=ref.hbm_gbps,
                          overhead_us=ref.overhead_us,
                          bytes_per_elem=ref.bytes_per_elem,
                          full_rate_channels=ref.mxu_min_channels)
    with open(os.path.join(REPO, "latency_lut_v5e.json")) as f:
        keys = [k for k in json.load(f) if not k.startswith("__")]
    assert len(keys) > 700
    for key in keys:
        assert model.provider(key) == pytest.approx(ref.provider(key),
                                                    rel=1e-9), key
    # the card's own constants price the same keys, all finite and > 0
    h100 = H100CostModel()
    assert all(0 < h100.provider(k) < 10 for k in keys)


def test_calibrate_raises_where_the_measurement_raises(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("measurement failed")

    monkeypatch.setattr(measure, "graph_slope_ms", broken)
    with pytest.raises(RuntimeError, match="measurement failed"):
        H100CostModel.calibrate(sample_shape=(8, 16, 16, 16), device="cpu")
