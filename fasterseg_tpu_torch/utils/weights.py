"""Weights for the port's DerivedNet: reference state_dicts, the JAX
package's variables, seeded random weights and the training init.

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


def from_jax_variables(plan: NetworkPlan, variables: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """The JAX package's DerivedNet variables ({"params", "batch_stats"},
    numpy leaves) as the port's state_dict: the inverse of the JAX
    package's `import_derived_state_dict`, HWIO -> OIHW."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def conv(tkey, p, bias=False):
        sd[f"{tkey}.weight"] = _t(p["conv"]["kernel"]).permute(3, 2, 0, 1) \
            .contiguous()
        if bias:
            sd[f"{tkey}.bias"] = _t(p["conv"]["bias"])

    def bn(tkey, p, s):
        sd[f"{tkey}.weight"] = _t(p["bn"]["scale"])
        sd[f"{tkey}.bias"] = _t(p["bn"]["bias"])
        sd[f"{tkey}.running_mean"] = _t(s["bn"]["mean"])
        sd[f"{tkey}.running_var"] = _t(s["bn"]["var"])

    def convnorm(tkey, name):
        conv(f"{tkey}.conv.0", params[name]["Conv_0"])
        bn(f"{tkey}.conv.1", params[name]["BatchNorm_0"],
           stats[name]["BatchNorm_0"])

    p_stem, s_stem = params["stem"], stats["stem"]
    conv("stem.0.conv.0", p_stem["stage0"]["Conv_0"])
    bn("stem.0.conv.1", p_stem["stage0"]["BatchNorm_0"],
       s_stem["stage0"]["BatchNorm_0"])
    for i in (1, 2):
        p, s = p_stem[f"stage{i}"], s_stem[f"stage{i}"]
        conv(f"stem.{i}.conv1", p["Conv_0"])
        bn(f"stem.{i}.bn1", p["BatchNorm_0"], s["BatchNorm_0"])
        conv(f"stem.{i}.conv2", p["Conv_1"])
        bn(f"stem.{i}.bn2", p["BatchNorm_1"], s["BatchNorm_1"])

    for c in plan.cells:
        if c.op == 0 and not c.down:
            continue  # identity skip has no weights
        name = f"cell_{c.layer}_{c.branch}"
        tkey = f"cells.{c.layer}-{c.branch}._op._op"
        for tsub, fsub, kind in _OP_LAYOUTS[c.op]:
            if kind == "conv":
                conv(f"{tkey}.{tsub}", params[name][fsub])
            else:
                bn(f"{tkey}.{tsub}", params[name][fsub], stats[name][fsub])

    if 2 in plan.lasts:
        for i in (0, 1):
            convnorm(f"arms32.{i}", f"arms32_{i}")
            convnorm(f"refines32.{i}", f"refines32_{i}")
    if 1 in plan.lasts:
        convnorm("arms16", "arms16")
        convnorm("refines16", "refines16")
    p, s = params["ffm"]["conv_1x1"], stats["ffm"]["conv_1x1"]
    conv("ffm.conv_1x1.conv", p["Conv_0"])
    bn("ffm.conv_1x1.bn", p["BatchNorm_0"], s["BatchNorm_0"])
    for head in ("heads8", *AUX_HEADS):
        if head not in params:
            continue
        p, s = params[head], stats[head]
        conv(f"{head}.conv_3x3.conv", p["conv_3x3"]["Conv_0"])
        bn(f"{head}.conv_3x3.bn", p["conv_3x3"]["BatchNorm_0"],
           s["conv_3x3"]["BatchNorm_0"])
        conv(f"{head}.conv_1x1", p["conv_1x1"], bias=True)
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
