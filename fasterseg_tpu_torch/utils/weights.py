"""Weights for the port's DerivedNet and Supernet: reference state_dicts,
the JAX package's variables, seeded random weights and the training init.

State_dict names are those of the reference `Network_Multi_Path_Infer`
(see models/derived.py); conv weights are OIHW.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping

import numpy as np
import torch

from ..core.plan import NetworkPlan
from ..ops.conv import BatchNorm

logger = logging.getLogger("fasterseg_tpu_torch")

# heads that exist for training only (models/derived.py)
AUX_HEADS = ("heads16", "heads32")

# per primitive: (reference child, JAX package submodule, kind)
_OP_LAYOUTS = {
    0: [("conv1", "Conv_0", "conv"), ("conv2", "Conv_1", "conv"),
        ("bn", "BatchNorm_0", "bn")],                      # FactorizedReduce s2
    1: [("conv1", "Conv_0", "conv"), ("bn1", "BatchNorm_0", "bn")],
    2: [("conv1", "Conv_0", "conv"), ("bn1", "BatchNorm_0", "bn")],
    3: [("conv1", "Conv_0", "conv"), ("bn1", "BatchNorm_0", "bn"),
        ("conv2", "Conv_1", "conv"), ("bn2", "BatchNorm_1", "bn")],
    4: [("conv1", "Conv_0", "conv"), ("bn1", "BatchNorm_0", "bn"),
        ("conv2", "Conv_1", "conv"), ("bn2", "BatchNorm_1", "bn")],
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv_into(sd: Dict, tkey: str, p: Mapping, bias: bool = False) -> None:
    """A flax conv's HWIO kernel (and bias) as `{tkey}.weight` OIHW."""
    sd[f"{tkey}.weight"] = _t(p["conv"]["kernel"]).permute(3, 2, 0, 1) \
        .contiguous()
    if bias:
        sd[f"{tkey}.bias"] = _t(p["conv"]["bias"])


def _bn_into(sd: Dict, tkey: str, p: Mapping, s: Mapping) -> None:
    """A flax BatchNorm's scale, bias and running statistics."""
    sd[f"{tkey}.weight"] = _t(p["bn"]["scale"])
    sd[f"{tkey}.bias"] = _t(p["bn"]["bias"])
    sd[f"{tkey}.running_mean"] = _t(s["bn"]["mean"])
    sd[f"{tkey}.running_var"] = _t(s["bn"]["var"])


def _convnorm_into(sd: Dict, tkey: str, p: Mapping, s: Mapping) -> None:
    """The JAX package's ConvNorm (Conv_0, BatchNorm_0) as ours
    (`conv.0`, `conv.1`)."""
    _conv_into(sd, f"{tkey}.conv.0", p["Conv_0"])
    _bn_into(sd, f"{tkey}.conv.1", p["BatchNorm_0"], s["BatchNorm_0"])


def _stem_into(sd: Dict, tkey: str, p: Mapping, s: Mapping) -> None:
    _convnorm_into(sd, f"{tkey}.0", p["stage0"], s["stage0"])
    for i in (1, 2):
        pi, si = p[f"stage{i}"], s[f"stage{i}"]
        _conv_into(sd, f"{tkey}.{i}.conv1", pi["Conv_0"])
        _bn_into(sd, f"{tkey}.{i}.bn1", pi["BatchNorm_0"], si["BatchNorm_0"])
        _conv_into(sd, f"{tkey}.{i}.conv2", pi["Conv_1"])
        _bn_into(sd, f"{tkey}.{i}.bn2", pi["BatchNorm_1"], si["BatchNorm_1"])


def _head_into(sd: Dict, tkey: str, p: Mapping, s: Mapping) -> None:
    _conv_into(sd, f"{tkey}.conv_3x3.conv", p["conv_3x3"]["Conv_0"])
    _bn_into(sd, f"{tkey}.conv_3x3.bn", p["conv_3x3"]["BatchNorm_0"],
             s["conv_3x3"]["BatchNorm_0"])
    _conv_into(sd, f"{tkey}.conv_1x1", p["conv_1x1"], bias=True)


def from_jax_variables(plan: NetworkPlan, variables: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """The JAX package's DerivedNet variables ({"params", "batch_stats"},
    numpy leaves) as the port's state_dict: the inverse of the JAX
    package's `import_derived_state_dict`, HWIO -> OIHW."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _stem_into(sd, "stem", params["stem"], stats["stem"])

    for c in plan.cells:
        if c.op == 0 and not c.down:
            continue  # identity skip has no weights
        name = f"cell_{c.layer}_{c.branch}"
        tkey = f"cells.{c.layer}-{c.branch}._op._op"
        for tsub, fsub, kind in _OP_LAYOUTS[c.op]:
            if kind == "conv":
                _conv_into(sd, f"{tkey}.{tsub}", params[name][fsub])
            else:
                _bn_into(sd, f"{tkey}.{tsub}", params[name][fsub],
                         stats[name][fsub])

    if 2 in plan.lasts:
        for i in (0, 1):
            for kind in ("arms32", "refines32"):
                _convnorm_into(sd, f"{kind}.{i}", params[f"{kind}_{i}"],
                               stats[f"{kind}_{i}"])
    if 1 in plan.lasts:
        for kind in ("arms16", "refines16"):
            _convnorm_into(sd, kind, params[kind], stats[kind])
    p, s = params["ffm"]["conv_1x1"], stats["ffm"]["conv_1x1"]
    _conv_into(sd, "ffm.conv_1x1.conv", p["Conv_0"])
    _bn_into(sd, "ffm.conv_1x1.bn", p["BatchNorm_0"], s["BatchNorm_0"])
    for head in ("heads8", *AUX_HEADS):
        if head in params:
            _head_into(sd, head, params[head], stats[head])
    return sd


def _slim_op_into(sd: Dict, tkey: str, op_idx: int, stride: int,
                  p: Mapping, s: Mapping) -> None:
    """One of the JAX package's slim primitives: SlimConv kernels, the
    stride-2 skip's two plain 1x1 kernels, and per-width BN tables
    (scale, bias, mean, var: (num_widths, C) each)."""
    def slim_bn(name):
        sd[f"{tkey}.{name}.weight"] = _t(p[name]["scale"])
        sd[f"{tkey}.{name}.bias"] = _t(p[name]["bias"])
        sd[f"{tkey}.{name}.running_mean"] = _t(s[name]["mean"])
        sd[f"{tkey}.{name}.running_var"] = _t(s[name]["var"])

    if op_idx == 0 and stride == 2:
        for name in ("conv1", "conv2"):
            _conv_into(sd, f"{tkey}.{name}", {"conv": p[name]})
        slim_bn("bn")
        return
    convs = ("conv1",) if op_idx < 3 else ("conv1", "conv2")
    for name in convs:
        _conv_into(sd, f"{tkey}.{name}.conv", p[name])
    for name in (("bn",) if op_idx == 0 else
                 tuple(f"bn{k + 1}" for k in range(len(convs)))):
        slim_bn(name)


def from_jax_supernet_variables(variables: Mapping, config
                                ) -> Dict[str, torch.Tensor]:
    """The JAX package's Supernet variables ({"params", "batch_stats"},
    numpy leaves) as the port's `models.supernet.Supernet` state_dict.
    `config` gives `layers` and `stem_head_width` (a SearchConfig).

    Both of the JAX package's layouts are read: unrolled `cell_{i}_{j}`,
    and the scan layout, whose layers 3..L-2 sit in `slayers/cell{j}` with
    every leaf stacked over those layers (the inverse of its
    `unrolled_to_scan_variables`)."""
    params, stats = variables["params"], variables["batch_stats"]
    L = config.layers
    sd: Dict[str, torch.Tensor] = {}

    def cell_tree(col: Mapping, i: int, j: int) -> Mapping:
        if f"cell_{i}_{j}" in col:
            return col[f"cell_{i}_{j}"]
        stacked = col["slayers"][f"cell{j}"]

        def pick(t):
            return ({k: pick(v) for k, v in t.items()}
                    if isinstance(t, Mapping) else np.asarray(t)[i - 3])
        return pick(stacked)

    for i in range(L):
        for j in range(min(i + 1, 3)):
            p, s = cell_tree(params, i, j), cell_tree(stats, i, j)
            for branch, stride in (("op", 1), ("down", 2)):
                if branch not in p:
                    continue
                for k in range(5):
                    _slim_op_into(sd, f"cells.{i}_{j}.{branch}.ops.{k}", k,
                                  stride, p[branch][f"op{k}"],
                                  s[branch][f"op{k}"])

    for a in range(len(config.stem_head_width)):
        _stem_into(sd, f"stems.{a}", params[f"stem{a}"], stats[f"stem{a}"])
        for name in ("refine16_0", "refine16_1", "refine32_0", "refine32_1",
                     "refine32_2", "refine32_3"):
            _convnorm_into(sd, f"refines.{a}.{name}", params[f"{name}{a}"],
                           stats[f"{name}{a}"])
        for name in ("head0", "head1", "head2", "head02", "head12"):
            _head_into(sd, f"heads.{a}.{name}", params[f"{name}{a}"],
                       stats[f"{name}{a}"])
    return sd


def load_reference_state_dict(net: torch.nn.Module, sd: Mapping) -> None:
    """Load a reference-named state_dict (tensors or numpy arrays) into
    `net`. Keys `net` does not use (the bypassed FFM attention) are ignored,
    and so is a missing `num_batches_tracked`. An aux head (`heads16`,
    `heads32`; training only) loads where `sd` carries every one of its
    tensors at `net`'s shapes and otherwise keeps its weights, with a
    warning: an eval checkpoint need not hold it. Any other key `net` needs
    raises."""
    own = net.state_dict()
    aux = lambda k: k.split(".")[0] in AUX_HEADS
    needed = lambda k: not k.endswith(".num_batches_tracked")
    missing = [k for k in own if needed(k) and not aux(k) and k not in sd]
    if missing:
        raise KeyError(f"state_dict lacks {len(missing)} keys, e.g. "
                       f"{missing[:5]}")
    skip = set()
    for head in AUX_HEADS:
        keys = [k for k in own if k.split(".")[0] == head and needed(k)]
        if keys and not all(k in sd and tuple(np.shape(sd[k]))
                            == tuple(own[k].shape) for k in keys):
            logger.warning("load_reference_state_dict: %s not in the "
                           "state_dict at the net's shapes; left as it is",
                           head)
            skip.add(head)
    net.load_state_dict({k: torch.as_tensor(np.asarray(sd[k]))
                         for k in own if k in sd
                         and k.split(".")[0] not in skip}, strict=False)


@torch.no_grad()
def init_random_(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded random weights with non-trivial BN statistics: Kaiming-normal
    (fan_in, ReLU) convs, BN gamma in [0.5, 1.5), beta and running mean
    N(0, 0.1^2), running var in [0.5, 2)."""
    g = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           * (2.0 / fan_in) ** 0.5)
            if m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
        elif isinstance(m, BatchNorm):
            n = m.num_features
            m.weight.copy_(torch.rand(n, generator=g) + 0.5)
            m.bias.copy_(torch.randn(n, generator=g) * 0.1)
            m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(n, generator=g) * 1.5 + 0.5)
    return net


@torch.no_grad()
def init_training_(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """The JAX package's training init, drawn from a torch.Generator seeded
    by `seed`: Kaiming-normal convs (variance 2 / fan_in, fan_in = k*k*c_in,
    ops/conv.py `KAIMING`), conv biases 0, BN scale 1 and bias 0, running
    mean 0 and variance 1."""
    g = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           * (2.0 / fan_in) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    return net
