"""Shared pieces of the search-slice tests (tests/test_torch_search_*.py):
the tiny configuration of tests/test_supernet.py in both packages, a
stand-in latency provider, the port's supernet weights as the JAX package's
variables, and JAX's random draws in the port's noise layout.
"""

import numpy as np
import pytest
import torch

LAYERS = 5
FCH = 8
WML = (4.0 / 12, 6.0 / 12, 8.0 / 12, 10.0 / 12, 1.0)
SHW = ((1.0, 1.0), (8.0 / 12, 8.0 / 12))
HW = (64, 128)   # the 1/32 scale stays non-degenerate for the zoomed convs


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while a module of these tests runs: the tiny
    supernet's many small ops slow down more than tenfold when six test
    workers each run eight threads on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def standin_ms(key: str) -> float:
    """A deterministic stand-in latency for any LUT key (a product of its
    sizes): the reference's table holds only Fch 12 keys, and the tests run
    Fch 8. Used the same way by both packages, so only equality matters."""
    from fasterseg_tpu_torch.latency.lut import parse_key
    _, f = parse_key(key)
    size = f.get("H", 1) * f.get("W", 1) * f.get("Cin", f.get("C", 1)) \
        * f.get("Cout", 1) * f.get("kernel", 3) ** 2
    return 0.01 + 1e-9 * size / f.get("stride", 1) ** 2 * (1 + len(key) % 7)


def tiny_configs(pretrain: bool, **kw):
    """tests/test_search.py's tiny_config (5 layers, Fch 8, batch 2 at
    64x128, eval at 64x128; the controller's band forces a doubling) in the
    port's and the JAX package's SearchConfig."""
    import fasterseg_tpu.core.config as jc
    import fasterseg_tpu_torch.core.config as tc
    out = []
    for c in (tc, jc):
        data = c.DataConfig(synthetic=True, synthetic_length=8,
                            image_height=HW[0], image_width=HW[1],
                            batch_size=2, gt_down_sampling=8,
                            num_classes=19)
        out.append(c.SearchConfig(
            data=data, eval=c.EvalConfig(eval_height=HW[0],
                                         eval_width=HW[1]),
            layers=LAYERS, Fch=FCH, pretrain=pretrain,
            latency_weight=(0.0, 1e-2), fps_min=(0.0, 1e9),
            fps_max=(0.0, 1e12), **kw))
    return tuple(out)


def port_lut():
    from fasterseg_tpu_torch.latency import LatencyLUT
    return LatencyLUT(provider=standin_ms)


@torch.no_grad()
def randomize_bn_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Non-trivial BN state (every slim row too): scale in [0.5, 1.5), bias
    and running mean N(0, 0.1^2), running var in [0.5, 2)."""
    from fasterseg_tpu_torch.ops.conv import BatchNorm
    from fasterseg_tpu_torch.ops.slimmable import SlimBatchNorm
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (BatchNorm, SlimBatchNorm)):
            shape = m.weight.shape
            m.weight.copy_(torch.rand(shape, generator=g) + 0.5)
            m.bias.copy_(torch.randn(shape, generator=g) * 0.1)
            m.running_mean.copy_(torch.randn(shape, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(shape, generator=g) * 1.5 + 0.5)
    return model


_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("batch_stats", "mean"),
       "running_var": ("batch_stats", "var")}


def _jax_path(key: str):
    """(collection, path) of a port Supernet state_dict key in the JAX
    package's unrolled layout, or None (num_batches_tracked)."""
    parts = key.split(".")
    leaf = parts[-1]
    if leaf == "num_batches_tracked":
        return None

    def flax(module: str):
        """A flax Conv (`Conv_n`: conv/kernel, conv/bias) or BatchNorm
        (`BatchNorm_n`: bn/scale ... bn/var) leaf."""
        if module.startswith("Conv"):
            return "params", [module, "conv",
                              "kernel" if leaf == "weight" else "bias"]
        col, name = _BN[leaf]
        return col, [module, "bn", name]

    if parts[0] == "cells":
        i, j = parts[1].split("_")
        base = [f"cell_{i}_{j}", parts[2], f"op{parts[4]}", parts[5]]
        if parts[5].startswith("conv"):
            # SlimConv's inner conv, or the stride-2 skip's plain conv
            return "params", base + (["conv", "kernel"] if parts[6] == "conv"
                                     else ["kernel"])
        col, name = _BN[leaf]
        return col, base + [name]
    a = parts[1]
    if parts[0] == "stems":
        if parts[2] == "0":      # ConvNorm: conv.0 / conv.1
            module = "Conv_0" if parts[4] == "0" else "BatchNorm_0"
        else:                    # BasicResidual2x: conv1 bn1 conv2 bn2
            kind = "Conv" if parts[3].startswith("conv") else "BatchNorm"
            module = f"{kind}_{int(parts[3][-1]) - 1}"
        col, tail = flax(module)
        return col, [f"stem{a}", f"stage{parts[2]}"] + tail
    if parts[0] == "refines":
        col, tail = flax("Conv_0" if parts[4] == "0" else "BatchNorm_0")
        return col, [f"{parts[2]}{a}"] + tail
    if parts[0] == "heads":
        head = f"{parts[2]}{a}"
        if parts[3] == "conv_1x1":
            return "params", [head, "conv_1x1", "conv",
                              "kernel" if leaf == "weight" else "bias"]
        col, tail = flax("Conv_0" if parts[4] == "conv" else "BatchNorm_0")
        return col, [head, "conv_3x3"] + tail
    raise KeyError(key)


def to_jax_supernet_variables(sd, layers: int):
    """The port Supernet's state_dict as the JAX package's Supernet
    variables in its scan layout (layers 3..L-2 stacked under
    slayers/cell{j}): the inverse of `from_jax_supernet_variables`."""
    flat = {}
    for key, v in sd.items():
        where = _jax_path(key)
        if where is None:
            continue
        col, path = where
        a = v.detach().cpu().numpy().astype(np.float32)
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)   # OIHW -> HWIO
        flat[(col, tuple(path))] = a
    out = {"params": {}, "batch_stats": {}}
    stacks = {}
    for (col, path), a in flat.items():
        name = path[0]
        if name.startswith("cell_"):
            i, j = (int(s) for s in name[5:].split("_"))
            if 3 <= i <= layers - 2:
                stacks.setdefault((col, ("slayers", f"cell{j}") + path[1:]),
                                  {})[i] = a
                continue
        node = out[col]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a
    for (col, path), by_layer in stacks.items():
        node = out[col]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.stack([by_layer[i]
                                   for i in range(3, layers - 1)])
    return out


def jax_ratio_noise(key, ratio_logits, mode: str, num_widths: int):
    """The draws JAX's `sample_ratios(key, ...)` makes, in the port's noise
    layout (`search.gumbel.draw_noise`)."""
    import jax
    keys = jax.random.split(key, len(ratio_logits))
    out = []
    for k, logits in zip(keys, ratio_logits):
        if mode == "arch_ratio":
            out.append(torch.from_numpy(np.array(jax.random.uniform(
                k, logits.shape))))
        elif mode == "random":
            out.append(torch.from_numpy(np.array(jax.random.randint(
                k, (logits.shape[0],), 0, num_widths))).long())
        else:
            out.append(None)
    return out
