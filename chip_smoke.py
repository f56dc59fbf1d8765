#!/usr/bin/env python3
"""Smoke run of fasterseg_tpu_torch on one NVIDIA card: build the kernels,
hold each against its plain version, and serve the shipped student and
teacher at 1024x2048 through the kernels.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --agreement-seeds 0,1,2,3,4

The second form builds the kernels and prints only the class-map agreement
readings of student and teacher for each seed, with the serving phases'
bars.

Run from the root of a checkout. Phases, one JSON line each:

  build          nvcc builds csrc/*.cu for sm_90a (one process per source,
                 all at once) into fasterseg_tpu_torch/build/
  kernels        each kernel against its plain PyTorch version on the card
                 at the shapes the serving path gives it (fp32 and bf16),
                 with its time (CUDA events over a CUDA graph of 20
                 launches), its bound and a PyTorch library yardstick
  reference      the kernel path in fp32 against the reference network's
                 output on the parity assets (tests/assets/parity_*.npz)
  serve_student  the student's .logits and .classmap in bf16 at 1024x2048
                 with seeded random weights: finite outputs, every kernel
                 counter rose, class-map agreement with the plain fp32 path,
                 ms/frame, launch by launch and replayed as a CUDA graph
  serve_teacher  one teacher .classmap with the same agreement checks

Then the kernels' summary line, the card's name and power limit as
nvidia-smi prints them, and last {"ok": true, "device": {...}}. Any failed
check raises and the script exits nonzero without that last line; so does a
host without CUDA. Needs no JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "tests", "assets")
HW = (1024, 2048)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# peak operation rates (H100 SXM data sheet, dense): bf16 products on the
# tensor cores; fp32 arithmetic on the CUDA cores
PEAK_OPS_PER_S = {"tensor_bf16": 989e12, "cuda_fp32": 67e12}
REPS = 20                          # launches per timing
AGREE_FP32 = 0.998                 # kernel path in fp32 vs plain fp32
# With seeded random weights the logits' top-2 margins are small, so bf16
# rounding alone flips pixels and no bf16 path reaches 99.8 % on the
# teacher. The bf16 kernel path is held to the bf16 plain path's own
# agreement with plain fp32, less this margin (readings over seeds 0-4 in
# PERF.md, `--agreement-seeds`).
NOISE_FLOOR_MARGIN = 0.0005


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, reps: int = REPS) -> float:
    """Device time of one call of `fn`: CUDA events around the replay of a
    CUDA graph of `reps` calls, so host overhead between launches is not
    counted. The median of 5 replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def call_ms(fn, reps: int = 7):
    """Per-call time with the host in the loop (serving as a caller sees
    it): CUDA events around each call after 2 warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "reps": reps}


def device_breakdown(fn, frames: int = 5, top: int = 12) -> dict:
    """Where one call of `fn` spends device time: torch.profiler (CUPTI)
    over `frames` calls after a warm-up. Busy time is the union of kernel
    and copy intervals; idle share = 1 - busy / host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(spans) > 0, "profiler saw no device activity")
    by_name = {}
    for start, end, name in spans:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + end - start, n + 1)
    busy, edge = 0.0, float("-inf")
    for start, end, _ in sorted(spans):
        if end > edge:
            busy += end - max(start, edge)
            edge = end
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"frames": frames,
            "wall_ms_per_frame": wall_us / frames / 1e3,
            "busy_ms_per_frame": busy / frames / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "kernels_per_frame": len(spans) / frames,
            "top": [{"name": name[:90], "ms_per_frame": t / frames / 1e3,
                     "calls_per_frame": n / frames}
                    for name, (t, n) in ranked[:top]]}


def bound(nbytes: float, ops: float, engine: str) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[engine] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------------- phases


def phase_build() -> dict:
    from fasterseg_tpu_torch.kernels import build
    t0 = time.perf_counter()
    seconds = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    ptxas = {}
    for name in build.SOURCES:
        with open(build.lib_path(name)[:-3] + ".log") as f:
            ptxas[name] = [line.strip() for line in f
                           if "registers" in line or "spill" in line]
    row = {"phase": "build", "seconds": time.perf_counter() - t0,
           "nvcc_seconds": seconds, "ptxas": ptxas, "gpu": gpu_line()}
    emit(row)
    return row


def _conv_inputs(rng, h, w, ci, co, device):
    import torch
    t = lambda a: torch.from_numpy(a.astype("float32")).to(device)
    return (t(rng.standard_normal((1, h, w, ci))),
            t(rng.standard_normal((3, 3, ci, co)) * (2.0 / (9 * ci)) ** 0.5),
            t(rng.random(co) + 0.5), t(rng.standard_normal(co) * 0.1))


def _conv_case(rng, label, h, w, ci, co, stride, device):
    import torch
    import torch.nn.functional as F
    from fasterseg_tpu_torch.kernels import conv3x3_bn_relu, conv3x3_bn_relu_plain
    x, wt, scale, bias = _conv_inputs(rng, h, w, ci, co, device)
    # fp32: the JAX package's bars (tests/test_pallas_conv.py:33,66)
    tol = 1e-4 if stride == 1 else 2e-4
    got = conv3x3_bn_relu(x, wt, scale, bias, stride=stride)
    want = conv3x3_bn_relu_plain(x, wt, scale, bias, stride=stride)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    err32 = (got - want).abs().max().item()
    # bf16 against the fp32 plain version of the same bf16-rounded inputs:
    # bf16 output rounding plus another order of summation
    xb = x.bfloat16()
    got = conv3x3_bn_relu(xb, wt, scale, bias, stride=stride)
    want = conv3x3_bn_relu_plain(xb.float(), wt, scale, bias, stride=stride)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    err16 = (got.float() - want).abs().max().item()
    check(bool(torch.isfinite(got.float()).all()), f"{label}: non-finite")

    # timing in bf16, the serving dtype
    y = torch.empty_like(got)
    w_lib = (wt * scale).permute(3, 2, 0, 1).contiguous().bfloat16() \
        .to(memory_format=torch.channels_last)
    b_lib = bias.bfloat16()
    x_lib = xb.permute(0, 3, 1, 2)             # NCHW view of NHWC memory

    def library():
        F.relu_(F.conv2d(x_lib, w_lib, b_lib, stride=stride, padding=1))

    ms = graph_ms(lambda: conv3x3_bn_relu(xb, wt, scale, bias, stride=stride))
    plain_ms = graph_ms(lambda: conv3x3_bn_relu_plain(xb, wt, scale, bias,
                                                      stride=stride))
    library_ms = graph_ms(library)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    nbytes = (xb.numel() * 2 + y.numel() * 2 + wt.numel() * 4 + 2 * co * 4)
    ops = 2.0 * ho * wo * co * 9 * ci
    # which of the two kernels of the .cu serves bf16 at this Ci
    tensor_cores = ci % 16 == 0
    return {"case": label, "shape": f"{h}x{w} {ci}->{co} s{stride}",
            "bf16_engine": "tensor cores" if tensor_cores else "cuda cores",
            "max_abs_err_fp32": err32, "max_abs_err": err16, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            **bound(nbytes, ops,
                    "tensor_bf16" if tensor_cores else "cuda_fp32")}


def _upsample_case(rng, device):
    import torch
    from fasterseg_tpu_torch.kernels import upsample8_argmax, upsample8_argmax_plain
    from fasterseg_tpu_torch.ops.resize import resize_bilinear
    h8, w8, c = HW[0] // 8, HW[1] // 8, 19
    # one-hot logits: exact agreement
    lbl = rng.integers(0, c, (1, h8, w8))
    onehot = torch.nn.functional.one_hot(torch.from_numpy(lbl), c)
    onehot = (onehot.float() * 10 - 5).to(device)
    for p8 in (onehot, onehot.bfloat16()):
        check(torch.equal(upsample8_argmax(p8), upsample8_argmax_plain(p8)),
              "upsample8_argmax: one-hot logits disagree")
    # random logits: the Pallas kernel's bar (tests/test_pallas.py:17)
    p8 = torch.from_numpy(rng.standard_normal((1, h8, w8, c))
                          .astype("float32")).to(device).bfloat16()
    got = upsample8_argmax(p8)
    want = upsample8_argmax_plain(p8)
    agree = (got == want).float().mean().item()
    check(agree >= 0.995, f"upsample8_argmax: agreement {agree} < 0.995")
    # error of the chosen class, in logits: max over pixels of
    # logit[plain's class] - logit[kernel's class] (0 where they agree)
    full = resize_bilinear(p8.float(), HW)
    pick = lambda k: full.gather(-1, k.long()[..., None])[..., 0]
    err = (pick(want) - pick(got)).abs().max().item()

    ms = graph_ms(lambda: upsample8_argmax(p8))
    plain_ms = graph_ms(lambda: upsample8_argmax_plain(p8))
    nbytes = p8.numel() * 2 + HW[0] * HW[1] * 4
    ops = HW[0] * HW[1] * c * 10.0       # 3 lerps (3 ops each) + a compare
    return {"case": "serving head", "shape": f"(1,{h8},{w8},{c}) bf16",
            "agree_random": agree, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            **bound(nbytes, ops, "cuda_fp32")}


def phase_kernels(seed: int) -> dict:
    import numpy as np
    import torch
    from fasterseg_tpu_torch.models import DerivedNet, student_plan
    device = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    net = DerivedNet(student_plan())
    refine = net.refines32[1].conv[0]            # the concat 64+32 -> 64
    H, W = HW
    s2 = [("stem stage0", H, W, 3, 32, 2),
          ("stem stage1 entry", H // 2, W // 2, 32, 64, 2)]
    s1 = [("stem stage1 conv2", H // 4, W // 4, 64, 64, 1),
          ("refine concat", H // 8, W // 8, refine.in_channels,
           refine.out_channels, 1),
          ("teacher 1/32", H // 32, W // 32, 384, 384, 1)]
    cases = {"conv3x3_bn_relu_s2": [_conv_case(rng, *c, device) for c in s2],
             "conv3x3_bn_relu_s1": [_conv_case(rng, *c, device) for c in s1],
             "upsample8_argmax": [_upsample_case(rng, device)]}
    torch.cuda.synchronize()
    row = {"phase": "kernels", "cases": cases}
    emit(row)
    return row


def phase_reference() -> dict:
    """The kernel path in fp32 on the card against the reference network's
    own output: tests/assets/parity_{student,teacher}.npz hold a reference
    `Network_Multi_Path_Infer` state_dict, an input and its eval-mode
    output. Bar: the parity test's 2e-4 (tests/test_torch_parity.py:43)."""
    import numpy as np
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan, teacher_plan)
    from fasterseg_tpu_torch.utils import load_reference_state_dict
    row = {"phase": "reference"}
    for name, plan_fn in (("student", student_plan), ("teacher", teacher_plan)):
        data = np.load(os.path.join(ASSETS, f"parity_{name}.npz"))
        plan = plan_fn()
        net = DerivedNet(plan)
        load_reference_state_dict(net, {k[len("state/"):]: data[k]
                                        for k in data.files
                                        if k.startswith("state/")})
        runner = InferenceRunner(plan, net, dtype=torch.float32, device=DEVICE)
        kernels.reset_launch_counts()
        got = runner.logits(torch.from_numpy(data["input"])).cpu()
        convs = kernels.launch_counts()
        check(all(n > 0 for k, n in convs.items() if k.startswith("conv")),
              f"reference {name}: the conv kernels did not run")
        want = torch.from_numpy(data["output"])
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        row[f"{name}_launches"] = convs
        row[f"{name}_max_abs_err"] = (got - want).abs().max().item()
        row[f"{name}_max_abs_output"] = want.abs().max().item()
    emit(row)
    return row


def _seeded_image(seed: int):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((1, *HW, 3))
                            .astype("float32"))


def _agreement(name: str, plan, net, x, cm) -> dict:
    """The bf16 kernel path's class map `cm` against the port's plain path:
    in fp32 with TF32 off (the reference) and in bf16; and the kernel path
    in fp32 against the same reference. Raises below the bars."""
    import torch
    from fasterseg_tpu_torch.models import InferenceRunner
    ref32 = InferenceRunner(plan, net, dtype=torch.float32, device=DEVICE,
                            fast_stem_enabled=False)
    cm32 = ref32.classmap(x)
    p8_32 = ref32.p8(x).float()
    del ref32
    ref16 = InferenceRunner(plan, net, dtype=torch.bfloat16, device=DEVICE,
                            fast_stem_enabled=False)
    cm_plain16 = ref16.classmap(x)
    del ref16
    k32 = InferenceRunner(plan, net, dtype=torch.float32, device=DEVICE)
    cm_k32 = k32.classmap(x)
    p8_k32 = k32.p8(x)
    del k32
    agree = lambda a, b=cm32: (a == b).float().mean().item()
    row = {
        "agree_bf16_kernels_vs_fp32_plain": agree(cm),
        "agree_bf16_plain_vs_fp32_plain": agree(cm_plain16),
        "agree_bf16_kernels_vs_bf16_plain": agree(cm, cm_plain16),
        "agree_fp32_kernels_vs_fp32_plain": agree(cm_k32),
        "p8_max_abs_err_fp32_kernels": (p8_k32 - p8_32).abs().max().item(),
        "p8_max_abs_fp32": p8_32.abs().max().item(),
        "classes_in_map": int(torch.unique(cm32).numel()),
    }
    check(row["agree_fp32_kernels_vs_fp32_plain"] >= AGREE_FP32,
          f"{name}: fp32 kernel class map agrees on "
          f"{row['agree_fp32_kernels_vs_fp32_plain']} < {AGREE_FP32}")
    floor = row["agree_bf16_plain_vs_fp32_plain"] - NOISE_FLOOR_MARGIN
    check(row["agree_bf16_kernels_vs_fp32_plain"] >= floor,
          f"{name}: bf16 kernel class map agrees on "
          f"{row['agree_bf16_kernels_vs_fp32_plain']}, below the bf16 "
          f"plain path's {row['agree_bf16_plain_vs_fp32_plain']}")
    torch.testing.assert_close(p8_k32, p8_32, rtol=5e-4, atol=5e-4)
    return row


def _serve(name: str, plan_fn, seed: int, timed: bool) -> dict:
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.models import DerivedNet, InferenceRunner
    from fasterseg_tpu_torch.utils import init_random_
    plan = plan_fn()
    net = init_random_(DerivedNet(plan), seed)
    x = _seeded_image(seed + 1).to(DEVICE)
    runner = InferenceRunner(plan, net, dtype=torch.bfloat16, device=DEVICE)

    # the main path: the counts are 0 just before and read just after
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    logits = runner.logits(x) if timed else None
    cm = runner.classmap(x)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for k in launches:
        check(launches[k] > 0, f"{name}: kernel {k} was not launched")

    check(cm.dtype == torch.int32 and tuple(cm.shape) == (1, *HW),
          f"{name}: class map {cm.dtype} {tuple(cm.shape)}")
    check(bool(((cm >= 0) & (cm < plan.num_classes)).all()),
          f"{name}: class index out of range")
    row = {"phase": f"serve_{name}", "plan_lasts": list(plan.lasts),
           "input": f"1x{HW[0]}x{HW[1]}x3", "dtype": "bfloat16",
           "launches": launches}
    if logits is not None:
        check(tuple(logits.shape) == (1, *HW, plan.num_classes)
              and logits.dtype == torch.bfloat16,
              f"{name}: logits {logits.dtype} {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits.float()).all()),
              f"{name}: non-finite logits")
        del logits
    row.update(_agreement(name, plan, net, x, cm))

    if timed:
        for what, fn in (("logits", lambda: runner.logits(x)),
                         ("classmap", lambda: runner.classmap(x))):
            t = call_ms(fn)
            row[f"{what}_ms"] = t
            row[f"{what}_fps"] = 1e3 / t["median"]
            # the same forward captured once as a CUDA graph and replayed:
            # the device's time without the host issuing ~180 launches
            row[f"graph_{what}_ms"] = graph_ms(fn, reps=1)
        plain16 = InferenceRunner(plan, net, dtype=torch.bfloat16,
                                  device=DEVICE, fast_stem_enabled=False)
        row["plain_bf16_classmap_ms"] = call_ms(lambda: plain16.classmap(x),
                                                reps=5)
        del plain16
        row["classmap_device"] = device_breakdown(lambda: runner.classmap(x))
        row["gpu"] = gpu_line()
    emit(row)
    return row


def phase_agreement_seeds(seeds) -> None:
    """Class-map agreement readings of student and teacher over seeds
    (weights and image), with the same bars as the serving phases."""
    import torch
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan, teacher_plan)
    from fasterseg_tpu_torch.utils import init_random_
    for seed in seeds:
        for name, plan_fn in (("student", student_plan),
                              ("teacher", teacher_plan)):
            plan = plan_fn()
            net = init_random_(DerivedNet(plan), seed)
            x = _seeded_image(seed + 1).to(DEVICE)
            runner = InferenceRunner(plan, net, dtype=torch.bfloat16,
                                     device=DEVICE)
            cm = runner.classmap(x)
            del runner
            emit({"phase": "agreement", "model": name, "seed": seed,
                  **_agreement(name, plan, net, x, cm)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--agreement-seeds", default=None, metavar="0,1,...",
                    help="only read class-map agreement over these seeds")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from fasterseg_tpu_torch.models import student_plan, teacher_plan

    if args.agreement_seeds is not None:
        phase_build()
        phase_agreement_seeds(int(v) for v in args.agreement_seeds.split(","))
        return 0

    t0 = time.perf_counter()
    build = phase_build()
    kern = phase_kernels(args.seed)
    phase_reference()
    student = _serve("student", student_plan, args.seed, timed=True)
    _serve("teacher", teacher_plan, args.seed, timed=False)

    from fasterseg_tpu_torch.kernels import build as kbuild
    sources = {"conv3x3_bn_relu_s1": "conv3x3_bn_relu",
               "conv3x3_bn_relu_s2": "conv3x3_bn_relu",
               "upsample8_argmax": "upsample8_argmax"}
    replaces = {
        "conv3x3_bn_relu_s1": "fasterseg_tpu/pallas/conv.py:148",
        "conv3x3_bn_relu_s2": "fasterseg_tpu/pallas/conv.py:336",
        "upsample8_argmax": "fasterseg_tpu/pallas/fused.py:82"}
    summary = []
    for name, cases in kern["cases"].items():
        c = cases[0]     # the heaviest serving shape of each kernel
        summary.append({
            "name": name, "route": "cuda",
            "source": f"fasterseg_tpu_torch/csrc/{sources[name]}.cu",
            "replaces": replaces[name],
            "launches": student["launches"][name],
            "shape": c["shape"], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    check(set(sources) == set(student["launches"]), "kernel list")
    check(all(s in kbuild.SOURCES for s in sources.values()), "sources")
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "build_seconds": build["seconds"]})
    emit({"kernels": summary})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
