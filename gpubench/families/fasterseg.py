"""The FasterSeg family: networks decoded from a searched genotype.

The reference's plan and forward are `gpubench/reference/plan.py` and
`net.py`, the seeded draw `gpubench/weights.py`, the program the port's
`InferenceRunner` over its `DerivedNet`, and the cost terms
`gpubench/flops.py`'s: the plan's conv FLOPs, the least time of its 3x3
convs, and the fused x8 upsample + argmax of a class map.
"""

from __future__ import annotations

from gpubench import flops, harness
from gpubench import weights as seeded
from gpubench.reference import net as ref_net
from gpubench.reference.plan import build_plan


def plan(config):
    return build_plan(config)


def weights(plan, seed, device):
    return seeded.make(plan, seed, device)


def reference_logits(plan, weights, x, precision=None):
    return ref_net.logits(plan, weights, x, precision or "fp32")


def program(config, weights, device, dtype):
    from fasterseg_tpu_torch.models import InferenceRunner
    pplan, net = harness.program_net(config, weights, device)
    return InferenceRunner(pplan, net, dtype=dtype, device=device)


def costs(plan, hw, elem_bytes):
    H, W = hw
    return {"flops_per_unit": flops.plan_flops(plan, hw),
            "conv_bound_s": flops.convs3x3_bound_s(plan, hw, elem_bytes),
            "convs3x3": len(flops.convs3x3(plan, hw)),
            "upsample_bound_s": flops.upsample_bound_s(
                H // 8, W // 8, plan.num_classes, H, W, elem_bytes),
            "upsamples": 1}
