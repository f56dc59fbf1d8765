"""CLI: serving-path profile of a decoded network on the card.

Counterpart of the JAX package's cli/profile.py (the reference profiles with
thop at build and its TensorRT timer loops, train_search.py:67-68 /
darts_utils.py:96-223). Prints one JSON line: static GFLOPs and parameters
(utils/flops.py) and the graph-slope-timed split of the serving path
(utils/profiling.py `serving_segments`), with random weights (seed 0); with
`--trace DIR` it also writes a Chrome trace of one forward.

  python -m fasterseg_tpu_torch.cli.profile                  # shipped student
  python -m fasterseg_tpu_torch.cli.profile --teacher --trace /tmp/trace
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default=None,
                   help="arch npz (default: shipped student genotype)")
    p.add_argument("--teacher", action="store_true")
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="also write a torch.profiler trace of one forward")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu times the plain "
                        "versions by wall clock, for tests)")
    args = p.parse_args(argv)

    import torch

    from ..models import (DerivedNet, InferenceRunner, student_plan,
                          teacher_plan)
    from ..models.infer import resolve_device
    from ..utils.flops import param_count, plan_flops
    from ..utils.profiling import serving_segments, trace
    from ..utils.weights import init_random_

    device = resolve_device(args.device)
    hw = (args.height, args.width)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    plan = (teacher_plan(arch_npz=args.arch) if args.teacher
            else student_plan(arch_npz=args.arch))
    net = init_random_(DerivedNet(plan), 0)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, *hw, 3), generator=g)

    row = {"network": "teacher" if args.teacher else "student",
           "input_hw": list(hw),
           "gflops": plan_flops(plan, hw) / 1e9,
           "mparams": param_count(net) / 1e6}
    row.update(serving_segments(plan, net, input_hw=hw, dtype=dtype,
                                device=device, x=x))
    if args.trace:
        runner = InferenceRunner(plan, net, dtype=dtype, device=device)
        xd = x.to(device=device, dtype=dtype)
        runner.logits(xd)                            # warm
        with trace(args.trace, device=device):
            runner.logits(xd)
        row["trace"] = args.trace
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
