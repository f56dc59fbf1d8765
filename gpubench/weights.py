"""Seeded weights of a configuration's network, made on the device.

Two draws from a `torch.Generator` on the run's device, one normal and one
uniform, each as long as all the parameters together, then cut into the
parameters of `reference.net.param_specs` in its order: conv weights
He-normal (std sqrt(2 / fan_in)), the classifier's bias N(0, 0.1), BN scale
U(0.5, 1.5), offset and running mean N(0, 0.1), running variance
U(0.5, 1.5). The same seed gives the same weights, whatever the program
does with them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.net import param_specs
from .reference.plan import Plan


def make(plan: Plan, seed: int, device) -> Dict[str, torch.Tensor]:
    specs = param_specs(plan)
    total = sum(math.prod(shape) for _, shape, kind in specs
                if kind != "bn_count")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind in specs:
        if kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind == "conv":
            t = z * math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
        elif kind in ("bn_weight", "bn_var"):
            t = 0.5 + u
        else:   # conv_bias, bn_bias, bn_mean
            t = 0.1 * z
        out[name] = t.contiguous()
    return out
