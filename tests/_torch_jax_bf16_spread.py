"""The JAX package's own bf16-vs-fp32 spread of one search-engine step, the
bars of tests/test_torch_search_bf16.py. Not collected by pytest; run it
from the repo root, on the CPU:

    JAX_PLATFORMS=cpu python tests/_torch_jax_bf16_spread.py

At tests/test_search.py's tiny configuration (5 layers, Fch 8, batch 2 at
64x128, `_torch_search_common.tiny_configs(pretrain=False)`), the JAX
SearchEngine in fp32 and in bf16 (`compute_dtype="bfloat16"`: parameters
fp32, supernet compute bf16) take the same step from the same state on the
same batch and keys: a pretrain weight step (`_weight_step(True)`, the
sandwich forwards), a search weight step and an arch step (the keys and
batch of tests/test_torch_search_engine.py's slow parity tests). For each
step it writes the loss's relative distance |l16 - l32| / |l32| and, for
every tensor the step moves (in the port's state_dict names, arch tensors
as `arch{idx}.{name}`), the relative L2 distance of the bf16 update to the
fp32 update, ||d16 - d32|| / ||d32||, with the ratio of their sizes
||d16|| / ||d32|| and the cosine of the angle between them, to
tests/_torch_bf16_spread.py.
"""

import os
import pprint
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# as tests/conftest.py: exact fp32 accumulation in XLA's CPU convs
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402

ARCH_NAMES = ("alpha0", "alpha1", "alpha2", "beta1", "beta2", "ratio0",
              "ratio1", "ratio2")
WEIGHT_KEY, ARCH_KEY = 21, 22


def batch():
    """tests/test_torch_search_engine.py's `_batch`."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 128, 3)).astype(np.float32)
    y = rng.integers(0, 19, (2, 8, 16)).astype(np.int32)
    y[1, :2, :5] = 255
    return x, y


def jax_engine(dtype: str):
    """The JAX package's search engine at the tiny configuration (whose
    weight step also runs pretrain's forwards) computing in `dtype`."""
    from fasterseg_tpu.latency import LatencyLUT
    from fasterseg_tpu.search import SearchEngine
    from _torch_search_common import standin_ms, tiny_configs
    _, jcfg = tiny_configs(pretrain=False, compute_dtype=dtype)
    lut = LatencyLUT(provider=standin_ms)
    # the JAX engine swaps an empty LUT for its TPU cost model (`lut or`)
    lut.get("ff_H1_W1_C1")
    return SearchEngine(jcfg, lut=lut), jcfg


def state_dict(engine, cfg, params, stats):
    from fasterseg_tpu_torch.utils.weights import from_jax_supernet_variables
    return {k: v.double() for k, v in from_jax_supernet_variables(
        jax.tree.map(np.asarray, {"params": params, "batch_stats": stats}),
        cfg).items()}


def arch_dict(aps):
    return {f"arch{idx}.{name}": np.asarray(t, np.float64)
            for idx in sorted(aps) for name, t in zip(
                ARCH_NAMES, list(aps[idx].alphas) + list(aps[idx].betas[1:])
                + list(aps[idx].ratios))}


def weight_step(engine, pretrain):
    """(loss, state_dict before, state_dict after) of one weight step."""
    x, y = batch()
    before = state_dict(engine, engine.config, engine.state.params,
                        engine.state.batch_stats)
    state, loss = engine._weight_step(pretrain)(
        jax.tree.map(jax.numpy.array, engine.state), engine.arch_params, x,
        y, jax.random.PRNGKey(WEIGHT_KEY))
    return float(loss), before, state_dict(engine, engine.config,
                                           state.params, state.batch_stats)


def arch_step(engine):
    """(loss_arch, arch tensors before, after) of one arch step."""
    x, y = batch()
    before = arch_dict(engine.arch_params)
    lat_w = jax.numpy.asarray(engine.controller.weights, np.float32)
    aps, _, _, am = engine._arch_step()(
        jax.tree.map(jax.numpy.array, engine.arch_params),
        jax.tree.map(jax.numpy.array, engine.arch_opt_state),
        engine.state.params, engine.state.batch_stats, x, y,
        jax.random.PRNGKey(ARCH_KEY), lat_w)
    return float(am["loss_arch"]), before, arch_dict(aps)


def relative(a, b) -> float:
    """||a - b|| / ||b||; 0 where both are 0."""
    num = float(np.linalg.norm(np.asarray(a, np.float64).ravel()
                               - np.asarray(b, np.float64).ravel()))
    den = float(np.linalg.norm(np.asarray(b, np.float64).ravel()))
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def size_and_cosine(a, b):
    """(||a|| / ||b||, the cosine of the angle between a and b)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    return na / nb, float(a @ b) / (na * nb)


def spread(run16, run32):
    (l16, b16, a16), (l32, b32, a32) = run16, run32
    tensors, size, cos = {}, {}, {}
    for k in a32:
        d32 = np.asarray(a32[k]) - np.asarray(b32[k])
        d16 = np.asarray(a16[k]) - np.asarray(b16[k])
        if not np.any(d32) and not np.any(d16):
            continue            # a tensor the step does not move
        tensors[k] = relative(d16, d32)
        size[k], cos[k] = size_and_cosine(d16, d32)
    return {"loss": abs(l16 - l32) / abs(l32), "tensors": tensors,
            "size": size, "cos": cos}


def main():
    import time
    t0 = time.perf_counter()
    engines = {d: jax_engine(d)[0] for d in ("float32", "bfloat16")}
    p32 = jax.tree.leaves(engines["float32"].state.params)
    p16 = jax.tree.leaves(engines["bfloat16"].state.params)
    assert all(np.array_equal(a, b) for a, b in zip(p32, p16))
    print(f"engines {time.perf_counter() - t0:.0f} s", flush=True)
    out = {}
    for name, step in (("pretrain_weight", lambda e: weight_step(e, True)),
                       ("search_weight", lambda e: weight_step(e, False)),
                       ("arch", arch_step)):
        runs = {d: step(e) for d, e in engines.items()}
        out[name] = spread(runs["bfloat16"], runs["float32"])
        print(f"{name} {time.perf_counter() - t0:.0f} s", flush=True)
    for name, s in out.items():
        t = s["tensors"]
        print(f"{name}: loss {s['loss']:.3g}; {len(t)} tensors, median "
              f"{np.median(list(t.values())):.3g}, max {max(t.values()):.3g}"
              f"; size median {np.median(list(s['size'].values())):.3g}, "
              f"cosine median {np.median(list(s['cos'].values())):.3g}")
    path = os.path.join(HERE, "_torch_bf16_spread.py")
    with open(path, "w") as f:
        f.write('"""The JAX package\'s bf16-vs-fp32 spread of one search-'
                'engine step at the tiny\nconfiguration, written by '
                'tests/_torch_jax_bf16_spread.py (which says how it\nis '
                'measured); the bars of tests/test_torch_search_bf16.py."""'
                '\n\nSPREAD = ')
        f.write(pprint.pformat(out, width=78, sort_dicts=True))
        f.write("\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
