"""The port's bench (fasterseg_tpu_torch/cli/bench.py) against bench.py and
the JAX package on the CPU, at 64x128.

The bench's JSON line carries bench.py's keys with their types and the
port's; its net is the JAX bench's draw (`create_derived(plan,
PRNGKey(0))`), and its runner in fp32 gives the JAX `InferenceRunner`'s
logits (Pallas in interpret mode). A failure anywhere fails the bench: no
fallback path, no `int8_error` key.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasterseg_tpu.models import InferenceRunner as JaxRunner
from fasterseg_tpu.models import student_plan as jax_student_plan
from fasterseg_tpu.models.derived import DerivedNet as JaxDerivedNet
from fasterseg_tpu_torch.cli import bench
from fasterseg_tpu_torch.models import fast_body
from fasterseg_tpu_torch.utils.weights import from_jax_variables
from _torch_search_common import few_threads  # noqa: F401 (autouse)
from test_torch_weights import HW

CPU = ["--device", "cpu", "--hw", f"{HW[0]},{HW[1]}"]

# bench.py's keys (bench.py:94-105, 121-123) and their types
BENCH_KEYS = {"metric": str, "value": float, "unit": str,
              "vs_baseline": float, "spread_pct": float, "spread_kind": str,
              "classmap_fps": float, "classmap_spread_pct": float,
              "classmap_spread_kind": str, "serving_path": str}
INT8_KEYS = {"int8_fps": float, "int8_spread_pct": float,
             "int8_serving_path": str}
PORT_KEYS = {"gpu": str, "hw": list, "dtype": str, "logits_ms": float,
             "classmap_ms": float, "int8_ms": float, "launches": dict,
             "launches_by_route": dict, "baseline": str}


@pytest.fixture(scope="module")
def built():
    """The bench's (plan, net, runner, x) in fp32 on the CPU."""
    return bench.build(HW, "cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX bench's plan and variables at HW: `create_derived(plan,
    PRNGKey(0))`'s, made by flax's lazy_init (without the forward)."""
    plan = jax_student_plan()
    model = JaxDerivedNet(plan=plan, dtype=jnp.bfloat16)
    shape = jax.ShapeDtypeStruct((1, *HW, 3), jnp.float32)
    variables = model.lazy_init(jax.random.PRNGKey(0), shape, train=True)
    return plan, jax.tree_util.tree_map(np.asarray, dict(variables))


def _last_json(out: str) -> dict:
    lines = out.strip().splitlines()
    assert lines, "no output"
    return json.loads(lines[-1])


def _no_json(out: str) -> None:
    assert "int8_error" not in out
    assert not any(line.lstrip().startswith("{")
                   for line in out.splitlines()), out


def test_main_prints_bench_keys_and_the_ports(capsys):
    result = bench.main(CPU)
    line = _last_json(capsys.readouterr().out)
    assert line == json.loads(json.dumps(result))
    for keys in (BENCH_KEYS, INT8_KEYS, PORT_KEYS):
        for k, t in keys.items():
            assert isinstance(line[k], t), (k, line[k])
    assert set(line) == set(BENCH_KEYS) | set(INT8_KEYS) | set(PORT_KEYS)
    assert line["metric"] == f"student_inference_fps_{HW[0]}x{HW[1]}_b1"
    assert line["unit"] == "fps" and line["serving_path"] == "fast_body"
    assert line["int8_serving_path"] == "fast_body"
    assert line["spread_kind"] == "raw_minmax"
    assert line["classmap_spread_kind"] == "trimmed"
    assert line["value"] == round(1e3 / line["logits_ms"], 2)
    assert line["vs_baseline"] == round(1e3 / line["logits_ms"] / 163.9, 3)
    assert line["classmap_fps"] == round(1e3 / line["classmap_ms"], 2)
    assert line["int8_fps"] == round(1e3 / line["int8_ms"], 2)
    for k in ("value", "classmap_fps", "int8_fps", "spread_pct",
              "classmap_spread_pct", "int8_spread_pct"):
        assert math.isfinite(line[k]) and line[k] >= 0, k
    assert line["gpu"] == "cpu" and line["hw"] == list(HW)
    assert line["dtype"] == "bfloat16"
    # the plain versions on the CPU launch no kernel
    assert set(line["launches"]) == {"conv3x3_bn_relu_s1",
                                     "conv3x3_bn_relu_s2", "upsample8_argmax",
                                     "resize_bilinear"}
    assert not any(line["launches"].values())
    assert line["baseline"].startswith("163.9 FPS")


def test_net_is_the_jax_benchs_draw(built, jax_bench):
    """Every tensor within 5e-7 and at least 98 % of the conv values bit
    for bit (test_torch_init_draw.py's bar)."""
    _, net, _, _ = built
    plan, variables = jax_bench
    want = from_jax_variables(plan, variables)
    own = net.state_dict()
    assert set(want) == {k for k in own
                         if not k.endswith("num_batches_tracked")}
    exact = total = 0
    for k, w in want.items():
        torch.testing.assert_close(own[k], w, rtol=5e-7, atol=1e-9, msg=k)
        if own[k].dim() == 4:
            exact += int((own[k] == w).sum())
            total += w.numel()
    assert exact >= 0.98 * total


def test_fp32_logits_match_jax_runner(built, jax_bench):
    """The bench's runner in fp32 (plain versions on the CPU) against the
    JAX `InferenceRunner` (Pallas stem + fast body, interpret mode) on the
    bench's image: test_torch_serving.py's 5e-4."""
    _, _, runner, x = built
    plan, variables = jax_bench
    jr = JaxRunner(plan, variables, dtype=jnp.float32)
    want = np.asarray(jr.logits(variables, jnp.asarray(x.numpy())))
    got = runner.logits(x).numpy()
    assert got.shape == want.shape == (1, *HW, 19)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def _boom(*args, **kwargs):
    raise RuntimeError("planted failure")


def test_fast_body_failure_fails_the_bench(capsys, monkeypatch):
    monkeypatch.setattr(fast_body, "conv3x3", _boom)
    with pytest.raises(RuntimeError, match="planted failure"):
        bench.main(CPU)
    _no_json(capsys.readouterr().out)


def test_int8_failure_fails_the_bench(capsys, monkeypatch):
    """Quantization raising after the bf16 timings fails the run; the int8
    leg was asked for once, on the default (kernel) path."""
    asked = []

    def boom(*args, **kwargs):
        asked.append(kwargs)
        _boom()

    monkeypatch.setattr(bench, "quantize_variables", boom)
    with pytest.raises(RuntimeError, match="planted failure"):
        bench.main(CPU)
    _no_json(capsys.readouterr().out)
    assert asked == [{"device": torch.device("cpu")}]


def test_no_int8(capsys, monkeypatch):
    made = []

    class Spy(bench.InferenceRunner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(bench, "InferenceRunner", Spy)
    monkeypatch.setattr(bench, "quantize_variables", _boom)
    bench.main(CPU + ["--no-int8"])
    line = _last_json(capsys.readouterr().out)
    assert not set(INT8_KEYS) & set(line) and "int8_ms" not in line
    assert "int8_error" not in line
    assert line["serving_path"] == "fast_body"
    assert [r.fast_stem_enabled for r in made] == [True]


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run_bench(HW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--hw", f"{HW[0]},{HW[1]}"])
