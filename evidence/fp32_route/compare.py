#!/usr/bin/env python3
"""Time the conv's fp32 route and the fp32 evaluation of one tree of the
port on one card, so that two trees (a commit and its parent, unpacked by
`git archive`) can be read in turns on the same card:

    python3 evidence/fp32_route/compare.py [--port-dir DIR] [--seed N]

DIR holds the `fasterseg_tpu_torch` to import (default: this checkout's).
Prints one JSON line: the tree, the card's name, power limit and clocks, and

* `convs`: each conv shape of chip_smoke.py's `kernels` phase in fp32: the
  wrapper's ms with the weights as the tree's fp32 runner hands them
  (packed once where the tree's `split_weights` takes a dtype, else the
  fp32 weights as they are), the plain version's and cuDNN's fp32 with TF32
  off, and the route where the tree counts routes;
* `logits_fp32_ms`: the student's fp32 `.logits` at 1024x2048 by graph
  replay; `classmap_bf16_ms` its bf16 class map (the serving path, a
  control);
* `K32`: the fp32 `Evaluator.run` over 4 ProcCity scenes at 1024x2048, ms
  per image at single scale and at multi-scale + flip over one scene, and
  torch.profiler's device busy time against the host's wall clock over one
  image of each (`device_breakdown`);
* `study_eval`: the ProcCity study's evaluation, `TrainSession.evaluate` of
  its 40 val scenes at 256x512 (what the `miou` phase's `eval_s_per_epoch`
  reads, there after each epoch), teacher and student with their initial
  weights: seconds (median of 3 after a warm-up) and the same profile.

Timing and profiling are chip_smoke.py's (`graph_ms`, `_run_ms`,
`device_breakdown`). Exits 2 without a card.
"""

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def conv_row(cs, rng, label, h, w, ci, co, stride, ci2) -> dict:
    import torch
    import torch.nn.functional as F
    from fasterseg_tpu_torch.kernels import conv as kconv
    from fasterseg_tpu_torch.kernels import (conv3x3_bn_relu,
                                             conv3x3_bn_relu_plain,
                                             split_weights)
    x, wt, scale, bias = cs._conv_inputs(rng, h, w, ci + ci2, co, cs.DEVICE)
    xa, x2 = ((x, None) if not ci2 else
              (x[..., :ci].contiguous(), x[..., ci:].contiguous()))
    try:
        cw = split_weights(wt, (ci, ci2) if ci2 else None, torch.float32)
    except TypeError:         # a tree whose fp32 convs take w as it is
        cw = wt
    kernel = lambda: conv3x3_bn_relu(xa, cw, scale, bias, stride=stride,
                                     x2=x2)
    counts = getattr(kconv, "route_launches", None)
    before = None if counts is None else dict(counts)
    got = kernel()
    route = (None if before is None else
             [r for r, n in counts.items() if n != before[r]][0])
    want = conv3x3_bn_relu_plain(x, wt, scale, bias, stride=stride)
    tol = 1e-4 if stride == 1 else 2e-4
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    w_lib = (wt * scale).permute(3, 2, 0, 1).contiguous() \
        .to(memory_format=torch.channels_last)
    x_lib = x.permute(0, 3, 1, 2)              # NCHW view of NHWC memory
    cin = f"{ci}+{ci2}" if ci2 else f"{ci}"
    return {"case": label, "shape": f"{h}x{w} {cin}->{co} s{stride}",
            "route": route, "max_abs_err": (got - want).abs().max().item(),
            "ms": cs.graph_ms(kernel),
            "plain_ms": cs.graph_ms(lambda: conv3x3_bn_relu_plain(
                x, wt, scale, bias, stride=stride)),
            "library_ms": cs.graph_ms(lambda: F.relu_(F.conv2d(
                x_lib, w_lib, bias, stride=stride, padding=1)))}


def study_eval(cs, stage: str, val) -> dict:
    from fasterseg_tpu_torch.cli import miou_study as ms
    from fasterseg_tpu_torch.train import TrainSession
    session = TrainSession(ms.study_config(stage), ms.ASSETS,
                           device=cs.DEVICE)
    session.evaluate(val)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        session.evaluate(val)
        times.append(time.perf_counter() - t0)
    return {"eval_s": statistics.median(times), "eval_s_all": times,
            "device": cs.device_breakdown(lambda: session.evaluate(val),
                                          frames=1, top=6, warmup=False)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port-dir", default=None, metavar="DIR",
                    help="import DIR/fasterseg_tpu_torch in place of this "
                         "checkout's")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.port_dir:
        sys.path.insert(0, os.path.abspath(args.port_dir))
    sys.path.insert(1 if args.port_dir else 0, REPO)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("compare.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    import fasterseg_tpu_torch
    from fasterseg_tpu_torch.cli import miou_study as ms
    from fasterseg_tpu_torch.core import DataConfig
    from fasterseg_tpu_torch.data.procgen import ProcCity
    from fasterseg_tpu_torch.eval import Evaluator
    from fasterseg_tpu_torch.kernels import build
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan)
    from fasterseg_tpu_torch.utils import init_random_
    seed = args.seed
    row = {"port": os.path.dirname(os.path.abspath(
        fasterseg_tpu_torch.__file__)), "gpu": cs.gpu_line(),
        "build_s": sum(build.build_all().values())}
    rng = np.random.default_rng(seed)
    row["convs"] = [conv_row(cs, rng, *c) for shapes in
                    cs._conv_shapes().values() for c in shapes]
    plan = student_plan()
    net = init_random_(DerivedNet(plan), seed)
    x = cs._seeded_image(seed + 1).to(cs.DEVICE)
    row["logits_fp32_ms"] = cs._fp32_logits_ms(plan, net, x)
    bf16 = InferenceRunner(plan, net, dtype=torch.bfloat16,
                           device=cs.DEVICE)
    row["classmap_bf16_ms"] = cs.graph_ms(lambda: bf16.classmap(x), reps=1)
    del bf16, x
    data = DataConfig()
    scenes = ProcCity(length=cs.EVAL_IMAGES, hw=cs.HW, seed=seed,
                      split="val")
    ds = [scenes[i] for i in range(cs.EVAL_IMAGES)]
    runner = InferenceRunner(plan, net, dtype=torch.float32,
                             device=cs.DEVICE)
    ev = lambda dataset, **kw: Evaluator(
        dataset, plan.num_classes, data.image_mean, data.image_std,
        runner.logits, ignore_label=data.ignore_label, device=cs.DEVICE,
        **kw)
    single = ev(ds)
    multi = ev(ds[:1], eval_scales=(0.75, 1.0, 1.25), eval_flip=True)
    row["K32"] = {
        "ms_per_image": cs._run_ms(single, cs.EVAL_IMAGES),
        "multi_flip_ms_per_image": cs._run_ms(multi, 1),
        "device": cs.device_breakdown(lambda: single.run(max_items=1),
                                      frames=2, top=6),
        "multi_flip_device": cs.device_breakdown(multi.run, frames=1,
                                                 top=6)}
    del runner, single, multi
    val = ms.render(ms.N_VAL, "val")
    row["study_eval"] = {stage: study_eval(cs, stage, val)
                         for stage in ("teacher", "student")}
    row["clocks"] = cs.clocks_line()
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
