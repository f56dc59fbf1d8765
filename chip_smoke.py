#!/usr/bin/env python3
"""Smoke run of fasterseg_tpu_torch on one NVIDIA card: build the kernels,
hold each against its plain version, serve the shipped student and teacher
at 1024x2048 through the kernels, evaluate the student on ProcCity scenes
through them, train the teacher and then the student from it, and pretrain and
search the supernet, then decode the searched student and run it through
the kernels, measure the latency table, run the ProcCity mIoU study whose
trained student then holds the bf16 and int8 class-map bars, and run the
self-search chain's stages (bf16 pretrain and search, training, fps,
report) on the study's scenes.

    python3 chip_smoke.py [--seed N] [--miou-epochs N]
    python3 chip_smoke.py --agreement-seeds 0,1,2,3,4
    python3 chip_smoke.py --profile-search
    python3 chip_smoke.py --latency-only [--detail-dir DIR]
    python3 chip_smoke.py --study-only [--miou-epochs N]
    python3 chip_smoke.py --distributed-only
    python3 chip_smoke.py --self-search-only

The second form builds the kernels and prints only the class-map agreement
readings of student and teacher for each seed, with the serving phases'
bars; the third builds them and runs only the search phase, with one search
step under torch.profiler; the fourth builds them, serves the student and
runs the latency phase (with DIR, it keeps the swept table and its
calibration there as latency_swept_h100_lut*.json); the fifth builds them
and runs only the miou, bf16_trained and int8 phases (`--miou-epochs 40`:
the 40 + 40 epoch study of MIOU.md); the sixth builds them, renders the
scenes and runs only the distributed phase; the seventh builds them, renders
the study's scenes and runs only the self_search phase.

Run from the root of a checkout. Phases, one JSON line each:

  build          nvcc builds csrc/*.cu for sm_90a (one process per source,
                 all at once) into fasterseg_tpu_torch/build/
  kernels        each kernel against its plain PyTorch version on the card
                 at the shapes the serving path gives it (fp32 and bf16),
                 with its time (CUDA events over a CUDA graph of 20
                 launches), its bound and a PyTorch library yardstick; the
                 conv's halo mode (a block of an image split over H with its
                 neighbours' rows) on each of its three routes against the
                 plain version with the same halos, timed beside the launch
                 without a halo on the same block
  reference      the kernel path in fp32 against the reference network's
                 output on the parity assets (tests/assets/parity_*.npz)
  serve_student  the student's .logits and .classmap in bf16 at 1024x2048
                 with seeded random weights: finite outputs, every kernel
                 counter rose, class-map agreement with the plain fp32 path,
                 ms/frame, launch by launch and replayed as a CUDA graph
  serve_teacher  one teacher .classmap with the same agreement checks
  eval_student   fasterseg_tpu_torch.eval.Evaluator over four 1024x2048
                 ProcCity scenes (data/procgen.py, seeded) with the student's
                 kernel path (bf16 K16, fp32 K32) and plain path (P32, TF32
                 off; P16) as the forward: every conv kernel counter rose in
                 the K16 run, hist distances between the runs and K32's
                 class maps against P32's within the bars, an exact hist on
                 the card; the conv kernels against their plain versions at
                 the shapes of the multi-scale (0.75, 1.25) and sliding
                 (1024 crop) inputs, and K32 against P32 there (1/8 logits,
                 class maps of multi-scale + flip and of sliding); mIoU,
                 ms per image
  train_teacher  fasterseg_tpu_torch.train.TrainSession in teacher mode at
                 the repo's TrainConfig (batch 12, 512x1024 crops of 12
                 ProcCity scenes through TrainPre and TrainLoader): two steps
                 with finite losses, the weights0_ckpt checkpoint written;
                 ms per step, images/s, peak memory, loader ms per batch
  train_student  student mode from that checkpoint (partial_load, 0
                 missing): two epochs of two steps with finite loss and
                 loss_kl > 0, every parameter and BN statistic moved, the
                 staircase learning rate at the epoch boundary, the loss
                 falling on one fixed batch; one step on the card against
                 the same step on the CPU (batch 2, 256x512, float64 and
                 fp32); exact resume under
                 deterministic algorithms; TrainSession.evaluate over the
                 eval scenes through the conv kernels against the plain fp32
                 net; the same readings as train_teacher, and the online
                 mIoU's counts timed for several numbers of private copies
  distributed    data parallelism (fasterseg_tpu_torch.parallel): (1) one
                 full-width distill step (batch 12 at 512x1024, fp32,
                 deterministic algorithms) on an NCCL mesh of one rank equal
                 bit for bit to the session's step without a mesh, both
                 timed in turns, with the bytes a step all-reduces; on two
                 gloo ranks sharing cuda:0, each against one rank: (2) the
                 float64 student step (256x512, batch 4) within atol 1e-10 +
                 rtol 1e-8, (3) Evaluator through the conv kernels over 5
                 scenes at 1024x2048 (hist identical, each rank's conv
                 launches > 0 and summing to the one-rank run's), (4) the
                 tiny search step in float64; (5) the dry run's steps
                 (parallel/dryrun.py) on the same two ranks; and spatial
                 evaluation on the same two ranks, each image split over H
                 (parallel/spatial.py): (S2) the student's fp32 logits of a
                 1024x2048 image within 1e-4 of one process's, (S3)
                 Evaluator(spatial=True) over the 5 scenes with bar (3)'s
                 hist, (S4) the same at scales 0.75, 1, 1.25 + flip over 2
                 scenes against one rank, (S5) bf16 spatial class maps
                 within the serving rule; halo-mode conv launches on both
                 ranks; the exchanges and bytes a forward, ms per image
  search         fasterseg_tpu_torch.search at the repo's SearchConfig (16
                 layers, Fch 12, five widths, teacher and student, the
                 reference LUT) on ProcCity scenes at 512x1024: a pretrain
                 epoch (batch 3, 256x512) with finite losses, every conv
                 weight moved and the arch parameters fixed; a search epoch
                 (batch 2, 224x448, two loaders) with every arch tensor
                 moved but the teacher's 1-wide ratios, loss_latency > 0
                 and equal to the estimator on the same draws; ms per step,
                 images/s, peak memory (remat on and off), loaders' ms per
                 batch; validate (five mIoUs in [0, 1]), arch_fps, the
                 controller's band rule; the searched student decoded and
                 run through all three kernels in fp32 against the plain
                 net; save and restore bit for bit; a tiny search step in
                 float64 on the card against the CPU
  latency        the LUT sweep (cli/latency_lut: every searchable op at
                 every width pair and stride, the supernet tables, both
                 stems, the four shipped walks) through the kernels into a
                 temporary table, with the conv counters rising at both
                 strides; zero misses on it and on the committed H100 table;
                 every distinct 3x3 conv shape of the sweep against its
                 plain version (fp32 1e-4 / 2e-4, bf16 2e-2) and timed
                 against cuDNN; cli/run_latency for student and teacher
                 (all three kernels launched; the student's graph-slope
                 class map within 5 % of serve_student's runner read in
                 the phase by the same graph slope on the same bf16 image,
                 medians of 5 turns taken in alternation, both spreads);
                 cli/calibrate_latency on the swept table (each plan's
                 calibrated walk within 10 % of measured); the auto FPS
                 band; cli/profile (stem + body_agg + upsample within 10 %
                 of logits). `--detail-dir DIR` keeps the long readings
  miou           cli/miou_study.py: 160 train / 40 val ProcCity scenes at
                 256x512 rendered once, the teacher (arch_0) for 8 epochs of
                 20 steps at batch 8, then the student (arch_1, KL from that
                 teacher) for 8, each evaluated after every epoch through the
                 conv kernels (fp32 runner), under deterministic algorithms
                 (a run repeats the last bit for bit): a row an epoch, finite
                 losses, val mIoU rising; bar: at each of steps 80-160 val
                 mIoU within 0.04 of the JAX package's column of MIOU.md
                 (teacher8, student8); ms per step, the loader's ms per
                 batch, eval seconds an epoch
  bf16_trained   the trained student's bf16 kernel class map against the
                 plain fp32 net over the 40 val scenes (bar 99.8 %, the JAX
                 package's) and on 4 val scenes at 1024x2048 (a reading),
                 every kernel counter rising; the conv and upsample kernels
                 against their plain versions at the study's shapes
  int8           cli/int8_check.py on that student: QuantizedRunner (int8
                 weights, bf16, the kernels) against the bf16 runner and
                 the plain fp32 net, with the JAX acceptance as its bars
                 (|delta mIoU| < 0.2 points; agreement >= max(min(99.9,
                 bf16 vs fp32 - 0.05), 99.5) %), the same acceptance in the
                 JAX package's arithmetic (plain bf16 nets) on the same
                 weights, and against its own plain fp32 net (bar 99.8 %),
                 every counter rising under it; qvars
                 saved, loaded and served; int8 and bf16 class maps by graph
                 replay at 1024x2048 and the bytes of qvars against fp32
  study_bars     the bars of miou, bf16_trained and int8, held after all
                 three have printed their rows: the list of those missed.
                 Where the JAX package's arithmetic misses int8's agreement
                 floor on the same weights too (the quantizer is the JAX
                 package's, bit for bit), the kernel path is held instead
                 to no more than 0.05 pp below that arithmetic's agreement,
                 and the floor's miss is listed apart with both readings
  self_search    cli/self_search.py's stages on the card at the chain's
                 configuration (16 layers, Fch 12, five widths, 256x512, 8
                 classes) on the miou phase's scenes, into a temporary
                 directory: a bf16 pretrain epoch and a bf16 search epoch of
                 one step each (finite losses; pretrain moves every conv
                 weight and no arch tensor, search every arch tensor but the
                 teacher's 1-wide ratios; step ms), validation on 2 val
                 scenes (25 mIoUs in [0, 1]), the band in band.json equal
                 to the committed H100 table's, the searched and the
                 shipped (control) teacher and student an epoch of two
                 steps each, fps (`.logits` of the searched student at
                 1024x2048 in bf16 through the kernels, conv launches > 0,
                 serving_path "kernels"), the report with every section;
                 then the JAX chain's own searched student
                 (evidence/self_search_r4, 8 classes) through all three
                 kernels: Evaluator hist within 1e-4 of the plain fp32
                 net, fp32 class map >= 99.8 %, bf16 within the serving
                 rule. Stage seconds

Then the kernels' summary line, the card's name and power limit as
nvidia-smi prints them, and last {"ok": true, "device": {...}}. Any failed
check raises and the script exits nonzero without that last line; so does a
host without CUDA. Needs no JAX.
"""

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

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
EVAL_IMAGES = 4                    # ProcCity scenes of the eval phase
# Share of pixels on which the fp32 kernel path's eval class maps may differ
# from the plain fp32 path's, and the bar of d(A, B) = 1/2 |hist_A -
# hist_B|_1 / labeled (a lower bound on the share of labeled pixels on which
# two predictions differ) between their hists. PERF.md's readings: 1.2e-7
# for fp32, 4.1e-4 for the bf16 kernel path; a bar between them fails a fp32
# path that computes in bf16.
EVAL_DIFF_FP32 = 1e-4
TRAIN_POOL = 12                    # ProcCity scenes the train phases crop
TRAIN_NITERS = 2                   # steps an epoch in the train phases
# Card against CPU, one student step: the same function, held in float64 on
# both (every tensor within atol 1e-10 + rtol 1e-8), and the fp32 loss to
# rtol 1e-4 (TF32 off). The fp32 tensors are read against atol 1e-5 + rtol
# 1e-4 and reported, not held: with cuDNN's autotuned algorithms the card's
# own fp32 rounding reached 3.7e-5 on a BN bias (PERF.md, training).
CARD_CPU_F64_ATOL, CARD_CPU_F64_RTOL = 1e-10, 1e-8
CARD_CPU_RTOL, CARD_CPU_ATOL = 1e-4, 1e-5


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


def clocks_line() -> str:
    """The card's SM clock, power draw and temperature now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                          "temperature.gpu", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
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


def host_us(fn, reps: int = 200) -> float:
    """Host time of one call of `fn` (the wrapper's Python, its checks, the
    tensor maps and the launch), the device left to run behind: wall clock
    over `reps` calls that are only enqueued."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


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


def device_breakdown(fn, frames: int = 5, top: int = 12,
                     warmup: bool = True) -> dict:
    """Where one call of `fn` spends device time: torch.profiler (CUPTI)
    over `frames` calls, after a warm-up call unless `fn` is warm already.
    Busy time is the union of kernel and copy intervals; idle share = 1 -
    busy / host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warmup:
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
    convs = [v for name, v in by_name.items() if "conv3x3_" in name]
    ups = [v for name, v in by_name.items() if "upsample_argmax_" in name]
    return {"frames": frames,
            "conv3x3_ms_per_frame": sum(t for t, _ in convs) / frames / 1e3,
            "conv3x3_calls_per_frame": sum(n for _, n in convs) / frames,
            "upsample_argmax_ms_per_frame":
                sum(t for t, _ in ups) / frames / 1e3,
            "upsample_argmax_calls_per_frame":
                sum(n for _, n in ups) / frames,
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


def _conv_case(rng, label, h, w, ci, co, stride, device, ci2=0, timed=True):
    """One conv shape; with `ci2` the two-input form (the refine convs): the
    kernel reads x[..., :ci] and x[..., ci:] from two tensors, the plain and
    library versions take the concat. `timed=False` checks the kernel and
    returns its errors only."""
    import torch
    import torch.nn.functional as F
    from fasterseg_tpu_torch.kernels import (conv3x3_bn_relu,
                                             conv3x3_bn_relu_plain,
                                             split_weights)
    x, wt, scale, bias = _conv_inputs(rng, h, w, ci + ci2, co, device)
    halves = lambda t: ((t, None) if not ci2 else
                        (t[..., :ci].contiguous(), t[..., ci:].contiguous()))
    # fp32: the JAX package's bars (tests/test_pallas_conv.py:33,66)
    tol = 1e-4 if stride == 1 else 2e-4
    xa, x2 = halves(x)
    got = conv3x3_bn_relu(xa, wt, scale, bias, stride=stride, x2=x2)
    want = conv3x3_bn_relu_plain(x, wt, scale, bias, stride=stride)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    err32 = (got - want).abs().max().item()
    # bf16 against the fp32 plain version of the same bf16-rounded inputs:
    # bf16 output rounding plus another order of summation. The weights are
    # split and packed once, as the runner does at construction.
    xb = x.bfloat16()
    xa, x2 = halves(xb)
    cw = split_weights(wt, (ci, ci2) if ci2 else None)
    got = conv3x3_bn_relu(xa, cw, scale, bias, stride=stride, x2=x2)
    want = conv3x3_bn_relu_plain(xb.float(), wt, scale, bias, stride=stride)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    err16 = (got.float() - want).abs().max().item()
    check(bool(torch.isfinite(got.float()).all()), f"{label}: non-finite")
    cin = f"{ci}+{ci2}" if ci2 else f"{ci}"
    row = {"case": label, "shape": f"{h}x{w} {cin}->{co} s{stride}",
           "max_abs_err_fp32": err32, "max_abs_err": err16}
    if not timed:
        return row

    # timing in bf16, the serving dtype
    y = torch.empty_like(got)
    w_lib = (wt * scale).permute(3, 2, 0, 1).contiguous().bfloat16() \
        .to(memory_format=torch.channels_last)
    b_lib = bias.bfloat16()
    x_lib = xb.permute(0, 3, 1, 2)             # NCHW view of NHWC memory

    def library():
        F.relu_(F.conv2d(x_lib, w_lib, b_lib, stride=stride, padding=1))

    kernel = lambda: conv3x3_bn_relu(xa, cw, scale, bias, stride=stride, x2=x2)
    ms = graph_ms(kernel)
    plain_ms = graph_ms(lambda: conv3x3_bn_relu_plain(xb, wt, scale, bias,
                                                      stride=stride))
    library_ms = graph_ms(library)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    # the weights as the kernel reads them: bf16 hi + lo, 4 bytes each
    nbytes = (xb.numel() * 2 + y.numel() * 2 + wt.numel() * 4 + 2 * co * 4)
    ops = 2.0 * ho * wo * co * 9 * (ci + ci2)
    # which kernel of the .cu serves bf16 at these channel counts
    tensor_cores = ci % 16 == 0 and ci2 % 16 == 0
    return {**row,
            "bf16_engine": "tensor cores" if tensor_cores else "cuda cores",
            "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "host_us": host_us(kernel), "library_host_us": host_us(library),
            **bound(nbytes, ops,
                    "tensor_bf16" if tensor_cores else "cuda_fp32")}


def _halo_case(rng, label, h, w, ci, co, stride, halo, dtype, route, ci2=0,
               *, device):
    """One conv in halo mode: a block of h rows of a taller image with
    halo = (top, bottom) of its neighbours' rows around it (the spatial
    evaluation's blocks), against the plain version with the same halos,
    on the kernel route `route` of csrc/conv3x3_bn_relu.cu (0 the CUDA-core
    kernel, 1 the Ci = 3 stem kernel, 2 the wgmma kernel); with `ci2` the
    two-input form. Timed beside the launch without a halo on the block's
    own h rows."""
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.kernels import conv as kconv
    from fasterseg_tpu_torch.kernels import (conv3x3_bn_relu,
                                             conv3x3_bn_relu_plain,
                                             split_weights)
    top, bottom = halo
    x, wt, scale, bias = _conv_inputs(rng, h + top + bottom, w, ci + ci2, co,
                                      device)
    bf16 = dtype == torch.bfloat16
    x = x.to(dtype)
    halves = lambda t: ((t.contiguous(), None) if not ci2 else
                        (t[..., :ci].contiguous(), t[..., ci:].contiguous()))
    xa, x2 = halves(x)
    ba, b2 = halves(x[:, top:top + h])
    tensor_cores = bf16 and ci % 16 == 0 and ci2 % 16 == 0
    cw = split_weights(wt, (ci, ci2) if ci2 else None) if bf16 else wt
    run = lambda a, b, hl: conv3x3_bn_relu(a, cw, scale, bias, stride=stride,
                                           x2=b, halo=hl)
    # the route the wrapper's plan gives this call (a fp32 concat is
    # written and takes one input)
    key = ((x.shape[1], w, ci, ci2, co, stride, 1, cw.ck, cw.bn, top, bottom)
           if tensor_cores else
           (x.shape[1], w, ci + ci2, 0, co, stride, int(bf16), 0, 0, top,
            bottom))
    got_route = kconv._plan(key)[0]
    check(got_route == route, f"halo {label}: route {got_route}, not {route}")
    name = f"conv3x3_bn_relu_s{stride}"
    before = kernels.halo_launch_counts()[name]
    got = run(xa, x2, halo)
    check(kernels.halo_launch_counts()[name] == before + 1,
          f"halo {label}: the halo-mode launch was not counted")
    want = conv3x3_bn_relu_plain(x.float(), wt, scale, bias, stride=stride,
                                 halo=halo)
    # the kernel bars: fp32 1e-4 at stride 1, 2e-4 at stride 2; bf16 2e-2
    tol = 2e-2 if bf16 else (1e-4 if stride == 1 else 2e-4)
    check(tuple(got.shape) == (1, (h - 1) // stride + 1, (w - 1) // stride + 1,
                               co), f"halo {label}: shape {tuple(got.shape)}")
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    cin = f"{ci}+{ci2}" if ci2 else f"{ci}"
    return {"case": label, "route": route,
            "shape": f"{h}x{w} {cin}->{co} s{stride}", "halo": list(halo),
            "dtype": str(dtype).split(".")[-1],
            "max_abs_err": (got.float() - want).abs().max().item(),
            "atol_rtol": tol, "ms": graph_ms(lambda: run(xa, x2, halo)),
            "ms_no_halo_same_block": graph_ms(lambda: run(ba, b2, (0, 0)))}


# Shapes the tile kernel can get wrong, beside the serving head: an output no
# tile and no group of four columns divides, one source row, one source
# column, one channel, the most channels the tile kernel takes (24, padded to
# 28), a small factor whose footprint still fits it (x5), and resizes that
# the pixel kernel serves (x3, x2, a downsample, 32 and 256 channels).
# (label, H8, W8, C, out_hw, dtype)
UPSAMPLE_EDGES = [
    ("serving head fp32", HW[0] // 8, HW[1] // 8, 19, None, "float32"),
    ("ragged output", 16, 32, 19, (100, 250), "float32"),
    ("ragged output bf16", 16, 32, 19, (100, 250), "bfloat16"),
    ("one source row", 1, 32, 19, (5, 250), "float32"),
    ("one source column", 16, 1, 19, (128, 7), "bfloat16"),
    ("one channel", 16, 32, 1, None, "float32"),
    ("24 channels", 16, 32, 24, None, "bfloat16"),
    ("32 channels (pixel kernel)", 16, 32, 32, None, "bfloat16"),
    ("x5", 16, 32, 19, (80, 160), "float32"),
    ("x3 (pixel kernel)", 16, 32, 19, (48, 96), "float32"),
    ("x2 (pixel kernel)", 16, 32, 19, (32, 64), "float32"),
    ("downsample (pixel kernel)", 16, 32, 19, (8, 40), "bfloat16"),
    ("256 channels (pixel kernel)", 16, 32, 256, None, "bfloat16"),
]


def _upsample_agreement(rng, device, h8, w8, c, out_hw, dtype, label):
    """Kernel against plain version on the card: the same map, pixel for
    pixel, on one-hot logits in fp32 and bf16 and on random logits of
    `dtype` (both kernels round as the plain version's matrix resize does).
    Returns the random logits, both maps and the agreement."""
    import torch
    from fasterseg_tpu_torch.kernels import upsample8_argmax, upsample8_argmax_plain
    lbl = rng.integers(0, c, (1, h8, w8))
    onehot = torch.nn.functional.one_hot(torch.from_numpy(lbl), c)
    onehot = (onehot.float() * 10 - 5).to(device)
    for p8 in (onehot, onehot.bfloat16()):
        check(torch.equal(upsample8_argmax(p8, out_hw),
                          upsample8_argmax_plain(p8, out_hw)),
              f"upsample8_argmax, {label}: one-hot logits disagree")
    p8 = torch.from_numpy(rng.standard_normal((1, h8, w8, c))
                          .astype("float32")).to(device).to(dtype)
    got = upsample8_argmax(p8, out_hw)
    want = upsample8_argmax_plain(p8, out_hw)
    check(got.shape == want.shape and got.dtype == torch.int32,
          f"upsample8_argmax, {label}: {got.dtype} {tuple(got.shape)}")
    agree = (got == want).float().mean().item()
    check(torch.equal(got, want),
          f"upsample8_argmax, {label}: random logits agree on {agree} < 1")
    return p8, got, want, agree


def _upsample_case(rng, device):
    import torch
    from fasterseg_tpu_torch.kernels import upsample8_argmax, upsample8_argmax_plain
    from fasterseg_tpu_torch.kernels.fused import _plan
    from fasterseg_tpu_torch.ops.resize import resize_bilinear
    h8, w8, c = HW[0] // 8, HW[1] // 8, 19
    p8, got, want, agree = _upsample_agreement(
        rng, device, h8, w8, c, None, torch.bfloat16, "serving head")
    # error of the chosen class, in logits: max over pixels of
    # logit[plain's class] - logit[kernel's class] (0 where they agree)
    full = resize_bilinear(p8.float(), HW)
    pick = lambda k: full.gather(-1, k.long()[..., None])[..., 0]
    err = (pick(want) - pick(got)).abs().max().item()
    del full

    ms = graph_ms(lambda: upsample8_argmax(p8))
    plain_ms = graph_ms(lambda: upsample8_argmax_plain(p8))
    p32 = p8.float()
    ms_fp32 = graph_ms(lambda: upsample8_argmax(p32))
    nbytes = p8.numel() * 2 + HW[0] * HW[1] * 4
    # The function's least work shares the H pass among the pixels of a
    # source column: one lerp (3 ops) and a compare a pixel-channel, plus one
    # lerp for each (output row, source column, channel). The unshared form
    # (3 lerps + a compare a pixel-channel) is kept beside it as
    # bound_unshared_ms.
    ops = HW[0] * HW[1] * c * 4.0 + HW[0] * w8 * c * 3.0
    ops_unshared = HW[0] * HW[1] * c * 10.0

    edges = []
    for label, eh, ew, ec, out_hw, dtype in UPSAMPLE_EDGES:
        _, g, _, a = _upsample_agreement(rng, device, eh, ew, ec, out_hw,
                                         getattr(torch, dtype), label)
        edges.append({"case": label, "shape": f"(1,{eh},{ew},{ec}) {dtype}",
                      "out_hw": list(g.shape[1:]), "agree_random": a,
                      "kernel": "tile" if _plan(eh, ew, ec, *g.shape[1:])[0]
                      else "pixel"})
    return {"case": "serving head", "shape": f"(1,{h8},{w8},{c}) bf16",
            "agree_random": agree, "max_abs_err": err, "ms": ms,
            "ms_fp32": ms_fp32, "plain_ms": plain_ms, "library_ms": None,
            **bound(nbytes, ops, "cuda_fp32"),
            "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_ops_ms": ops / PEAK_OPS_PER_S["cuda_fp32"] * 1e3,
            "bound_unshared_ms":
                ops_unshared / PEAK_OPS_PER_S["cuda_fp32"] * 1e3,
            "kernel": "tile" if _plan(h8, w8, c, *HW)[0] else "pixel",
            "edges": edges}


def phase_kernels(seed: int) -> dict:
    import numpy as np
    import torch
    from fasterseg_tpu_torch.models import DerivedNet, student_plan
    device = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    net = DerivedNet(student_plan())
    refine = net.refines32[1].conv[0]            # the concat 64+32 -> 64
    arm_out = net.arms32[1].conv[0].out_channels  # its first input's channels
    H, W = HW
    s2 = [("stem stage0", H, W, 3, 32, 2),
          ("stem stage1 entry", H // 2, W // 2, 32, 64, 2),
          ("teacher stem stage0", H, W, 3, 48, 2)]
    s1 = [("stem stage1 conv2", H // 4, W // 4, 64, 64, 1),
          ("refine concat", H // 8, W // 8, refine.in_channels,
           refine.out_channels, 1),
          ("teacher 1/32", H // 32, W // 32, 384, 384, 1),
          ("student 1/32 cell", H // 32, W // 32, 64, 64, 1),
          ("teacher 1/32 cell", H // 32, W // 32, 192, 192, 1)]
    cases = {"conv3x3_bn_relu_s2": [_conv_case(rng, *c, device) for c in s2],
             "conv3x3_bn_relu_s1": [_conv_case(rng, *c, device) for c in s1],
             "upsample8_argmax": [_upsample_case(rng, device)]}
    # the refine conv again, its concat read from two tensors (64 + 32)
    cases["conv3x3_bn_relu_s1"].append(_conv_case(
        rng, "refine, two inputs", H // 8, W // 8,
        arm_out, refine.out_channels, 1, device,
        ci2=refine.in_channels - arm_out))
    # (S1) the halo mode on every route, at the blocks of a spatial
    # evaluation (the image's 1024 rows split over ranks)
    f32, b16 = torch.float32, torch.bfloat16
    ci2 = refine.in_channels - arm_out
    halo = [_halo_case(rng, *c, device=device) for c in (
        ("stem entry", H // 2, W, 3, 32, 2, (1, 0), f32, 0),
        ("stem stage1 conv2", H // 4, W // 4, 64, 64, 1, (1, 1), f32, 0),
        ("refine concat", H // 8, W // 8, arm_out, refine.out_channels, 1,
         (1, 1), f32, 0, ci2),
        ("stem entry", H // 2, W, 3, 32, 2, (1, 0), b16, 1),
        ("stem stage1 entry", H // 2, W // 2, 32, 64, 2, (1, 0), b16, 2),
        ("stem stage1 conv2", H // 4, W // 4, 64, 64, 1, (1, 1), b16, 2),
        ("refine, two inputs", H // 8, W // 8, arm_out, refine.out_channels,
         1, (1, 1), b16, 2, ci2))]
    torch.cuda.synchronize()
    row = {"phase": "kernels", "cases": cases, "halo_cases": halo}
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


def _hist_d(a, b) -> float:
    """1/2 |a - b|_1 / labeled of two confusion hists of the same labels."""
    import numpy as np
    return 0.5 * float(np.abs(a - b).sum()) / max(int(b.sum()), 1)


def _diff(a, b) -> float:
    """Share of pixels on which two class maps differ."""
    return (a != b).float().mean().item()


def _run_ms(ev, n_images: int) -> float:
    """ms per image of `ev.run()`, host included: one warm-up image, then
    the median of two runs over the dataset."""
    ev.run(max_items=1)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        ev.run()
        times.append((time.perf_counter() - t0) * 1e3 / n_images)
    return statistics.median(times)


def phase_eval(seed: int) -> dict:
    """Whole-image evaluation of the student through the kernels (K16, K32)
    and through the plain network (P32 with TF32 off, the counterpart of
    the JAX TrainSession.evaluate forward; P16, the bf16 noise floor)."""
    import numpy as np
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.core import DataConfig
    from fasterseg_tpu_torch.core.config import EvalConfig
    from fasterseg_tpu_torch.data.procgen import ProcCity
    from fasterseg_tpu_torch.data.preprocess import _resize, eval_preprocess
    from fasterseg_tpu_torch.eval import (Evaluator, confusion_hist,
                                          probabilities)
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan)
    from fasterseg_tpu_torch.utils import init_random_
    data = DataConfig()
    H, W = HW
    plan = student_plan()
    n = plan.num_classes
    net = init_random_(DerivedNet(plan), seed)
    t0 = time.perf_counter()
    scenes = ProcCity(length=EVAL_IMAGES, hw=HW, seed=seed, split="val")
    ds = [scenes[i] for i in range(EVAL_IMAGES)]
    render_s = time.perf_counter() - t0
    labels = np.stack([s["label"] for s in ds])
    n_valid = int(((labels != data.ignore_label) & (labels < n)).sum())
    forwards = {"K16": (torch.bfloat16, True), "K32": (torch.float32, True),
                "P32": (torch.float32, False), "P16": (torch.bfloat16, False)}

    def runner(name):
        dtype, fast = forwards[name]
        return InferenceRunner(plan, net, dtype=dtype, device=DEVICE,
                               fast_stem_enabled=fast)

    def evaluator(fwd, dataset=ds, **kw):
        return Evaluator(dataset, n, data.image_mean, data.image_std, fwd,
                         ignore_label=data.ignore_label, device=DEVICE, **kw)

    row = {"phase": "eval_student", "images": f"{EVAL_IMAGES}x{HW[0]}x{HW[1]}",
           "dataset": "ProcCity", "render_s": render_s, "labeled": n_valid,
           "label_classes": sorted(int(c) for c in np.unique(labels))}
    hists, maps = {}, {}
    for name in forwards:
        r = runner(name)
        ev = evaluator(r.logits)
        if name == "K16":
            # the main path: the counts are 0 just before and read just after
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            res = ev.run()
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            for k in ("conv3x3_bn_relu_s1", "conv3x3_bn_relu_s2"):
                check(launches[k] > 0, f"eval: kernel {k} was not launched")
            row["launches"] = launches
            # image 0: its hist on the card against numpy's on the host, and
            # its time split into the forward alone and the fp32
            # probabilities + argmax + hist on the forward's logits
            x = torch.from_numpy(eval_preprocess(
                ds[0]["data"], data.image_mean, data.image_std)[None]
            ).to(DEVICE)
            lab = torch.from_numpy(labels[:1].astype(np.int32)).to(DEVICE)
            logits = r.logits(x)

            def hist0():
                pred = torch.argmax(probabilities(logits), -1).int()
                return pred, confusion_hist(pred, lab, n, data.ignore_label)

            pred, on_card = hist0()
            p, l = pred.cpu().numpy().astype(np.int64), labels[:1].astype(
                np.int64)
            valid = (l != data.ignore_label) & (l < n)
            on_host = np.bincount(n * l[valid] + p[valid],
                                  minlength=n * n).reshape(n, n)
            check(torch.equal(on_card.cpu(), torch.from_numpy(on_host)),
                  "eval: the card's hist of image 0 differs from numpy's")
            def upload():
                # what run() sends the card an image: uint8 image, int32
                # labels, from pageable host memory
                return (torch.from_numpy(ds[0]["data"][None]).to(DEVICE),
                        torch.from_numpy(labels[:1].astype(np.int32))
                        .to(DEVICE))

            row["k16_run_one_ms"] = call_ms(lambda: ev.run(max_items=1))
            row["k16_upload_ms"] = call_ms(upload)
            row["k16_forward_ms"] = call_ms(lambda: r.logits(x))
            row["k16_probs_argmax_hist_ms"] = call_ms(hist0)
            del logits, x, pred
        else:
            res = ev.run()
        check(int(res.hist.sum()) == n_valid,
              f"eval {name}: hist sums to {int(res.hist.sum())}, "
              f"labeled {n_valid}")
        hists[name] = res.hist
        if name in ("K32", "P32"):
            # the class maps of every image, to compare pixel by pixel
            maps[name] = torch.cat([ev._predict_whole(s["data"][None])
                                    for s in ds])
        row[f"{name}_miou"] = res.mean_iu
        row[f"{name}_pixel_acc"] = res.pixel_acc
        if name in ("K16", "P16"):
            row[f"{name}_ms_per_image"] = _run_ms(ev, EVAL_IMAGES)
        del r, ev
    row["d_K32_P32"] = _hist_d(hists["K32"], hists["P32"])
    row["d_K16_P32"] = _hist_d(hists["K16"], hists["P32"])
    row["d_P16_P32"] = _hist_d(hists["P16"], hists["P32"])
    row["d_K16_P16"] = _hist_d(hists["K16"], hists["P16"])
    row["diff_K32_P32"] = _diff(maps["K32"], maps["P32"])
    del maps
    for key in ("d_K32_P32", "diff_K32_P32"):
        check(row[key] <= EVAL_DIFF_FP32,
              f"eval: {key} = {row[key]} > {EVAL_DIFF_FP32}")
    check(row["d_K16_P32"] <= row["d_P16_P32"] + NOISE_FLOOR_MARGIN,
          f"eval: d(K16, P32) = {row['d_K16_P32']} > d(P16, P32) "
          f"{row['d_P16_P32']} + {NOISE_FLOOR_MARGIN}")

    # multi-scale + flip and sliding on image 0 run the convs at 768x1536,
    # 1280x2560 and 1024x1024, which serving never sends: the kernels at
    # those inputs' stem and 1/32 shapes against their plain versions, the
    # fp32 kernel path's 1/8 logits of the scene against the plain path's,
    # then both paths' class maps pixel by pixel
    scales = (0.75, 1.0, 1.25)
    crop = EvalConfig().eval_crop_size
    img = ds[0]["data"]
    inputs = {f"{int(H * s)}x{int(W * s)}":
              _resize(img, (int(W * s), int(H * s)), nearest=False)
              for s in scales if s != 1.0}
    inputs[f"{crop}x{crop} crop"] = img[:crop, :crop]
    rng = np.random.default_rng(seed)
    k32, p32 = runner("K32"), runner("P32")
    row["eval_shapes"] = []
    for what, im in inputs.items():
        h, w = im.shape[:2]
        for label, hh, ww, ci, co, stride in (
                ("stem stage0", h, w, 3, 32, 2),
                ("stem stage1 entry", h // 2, w // 2, 32, 64, 2),
                ("student 1/32 cell", h // 32, w // 32, 64, 64, 1)):
            row["eval_shapes"].append(_conv_case(
                rng, f"{label} of {what}", hh, ww, ci, co, stride,
                torch.device(DEVICE), timed=False))
        x = torch.from_numpy(eval_preprocess(
            im, data.image_mean, data.image_std)[None]).to(DEVICE)
        got, want = k32.p8(x).float(), p32.p8(x).float()
        torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)
        row["eval_shapes"].append({
            "case": f"p8 logits of {what}",
            "max_abs_err_fp32": (got - want).abs().max().item(),
            "max_abs_fp32": want.abs().max().item()})
        del x, got, want

    multi = dict(eval_scales=scales, eval_flip=True)
    evs = {name: evaluator(r.logits, ds[:1], **multi)
           for name, r in (("K32", k32), ("P32", p32))}
    res = {name: ev.run() for name, ev in evs.items()}
    row["d_multi_flip_K32_P32"] = _hist_d(res["K32"].hist, res["P32"].hist)
    maps = {name: ev._predict_whole(img[None]) for name, ev in evs.items()}
    row["diff_multi_flip_K32_P32"] = _diff(maps["K32"], maps["P32"])
    row["K32_multi_flip_ms_per_image"] = _run_ms(evs["K32"], 1)
    slid = {name: evaluator(r.logits).sliding_eval(img, crop)
            for name, r in (("K32", k32), ("P32", p32))}
    del k32, p32, evs, maps
    check(slid["K32"].shape == HW and slid["K32"].dtype == np.int32,
          f"eval: sliding class map {slid['K32'].dtype} {slid['K32'].shape}")
    row["diff_sliding_K32_P32"] = float((slid["K32"] != slid["P32"]).mean())
    for key in ("d_multi_flip_K32_P32", "diff_multi_flip_K32_P32",
                "diff_sliding_K32_P32"):
        check(row[key] <= EVAL_DIFF_FP32,
              f"eval: {key} = {row[key]} > {EVAL_DIFF_FP32}")
    row["gpu"] = gpu_line()
    emit(row)
    return row, ds


# ------------------------------------------------------------------ training


def _train_config(mode: str, seed: int, hw=(512, 1024), batch: int = 12):
    """The repo's TrainConfig for `mode` (lr 0.01, momentum 0.9, weight
    decay 5e-4, x0.992 an epoch, OHEM 0.7 with min_kept = batch*h*w/16, aux
    0.2) at batch `batch` and `hw` crops, TRAIN_NITERS steps an epoch."""
    import dataclasses
    from fasterseg_tpu_torch.core.config import (DataConfig,
                                                 cityscapes_student_config,
                                                 cityscapes_teacher_config)
    make = (cityscapes_teacher_config if mode == "teacher"
            else cityscapes_student_config)
    return make(data=DataConfig(image_height=hw[0], image_width=hw[1],
                                batch_size=batch),
                niters_per_epoch=TRAIN_NITERS, seed=seed)


def _train_pool(seed: int):
    """TRAIN_POOL ProcCity train scenes at 1024x2048, rendered once (eight
    threads) and held in memory: the train loader's dataset."""
    from concurrent.futures import ThreadPoolExecutor
    from fasterseg_tpu_torch.data.procgen import ProcCity
    scenes = ProcCity(length=TRAIN_POOL, hw=HW, seed=seed, split="train")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        pool = list(ex.map(scenes.__getitem__, range(TRAIN_POOL)))
    return pool, time.perf_counter() - t0


def _loader(cfg, pool):
    from fasterseg_tpu_torch.data import TrainLoader, TrainPre
    d = cfg.data
    pre = TrainPre(d.image_mean, d.image_std, (d.image_height, d.image_width),
                   d.train_scale_array, d.gt_down_sampling, d.ignore_label)
    return TrainLoader(pool, pre, d.batch_size, seed=cfg.seed)


def _on_card(batch):
    import torch
    return tuple(torch.from_numpy(a).to(DEVICE) for a in batch)


def _step_readings(session, loader, x, y) -> dict:
    """ms per train step (CUDA events around `session.step` on a batch
    already on the card: 2 warm-ups, then the median of 5 with min/max),
    images/s, peak memory over those steps, the loader's ms per batch
    alone (host, median of 3) and the losses of all 7 steps."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = session.step(x, y)
        end.record()
        end.synchronize()
        losses.append(m["loss"].item())
        if i >= 2:
            times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    loader_ms = []
    for step in range(3):
        t0 = time.perf_counter()
        loader.make_batch(99, step)
        loader_ms.append((time.perf_counter() - t0) * 1e3)
    return {"step_ms": {"median": ms, "min": min(times), "max": max(times),
                        "reps": len(times)},
            "images_per_s": x.shape[0] / ms * 1e3,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "loader_ms_per_batch": statistics.median(loader_ms),
            "loader_pool": loader.pool_size, "nproc": os.cpu_count(),
            "fixed_batch_losses": losses}


def _count_copies_probe(labels) -> dict:
    """One count of the online mIoU (`eval.metrics._bincount`, 20 bins, the
    batch's labels as the values: three such counts a step) timed for
    several numbers of private copies of the bins; every count equal."""
    import torch
    from fasterseg_tpu_torch.eval import metrics
    idx = (labels.long() + 1).clamp(0, 19).reshape(-1)
    want = metrics._bincount(idx, 20, 1)
    out = {"values": idx.numel(), "chosen": metrics.COUNT_COPIES}
    for copies in (1, 8, 64, 512, 4096):
        check(torch.equal(metrics._bincount(idx, 20, copies), want),
              f"counts with {copies} copies differ")
        out[str(copies)] = call_ms(lambda: metrics._bincount(idx, 20,
                                                             copies))["median"]
    return out


def _finite_steps(stats, name, kl: bool):
    import math
    for loss, loss_kl in zip(stats["losses"], stats["losses_kl"]):
        check(math.isfinite(loss), f"{name}: loss {loss}")
        check(loss_kl > 0 if kl else loss_kl == 0,
              f"{name}: loss_kl {loss_kl}")


def phase_train_teacher(seed: int, pool, save_dir: str) -> dict:
    """Teacher mode at batch 12, 512x1024: the main path is two steps
    through TrainSession.train_epoch on the loader, then save()."""
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.train import TrainSession
    t0 = time.perf_counter()
    # as cli/train.py does: with cuDNN's heuristic choice of algorithm for
    # fp32 convs without TF32 (FFT) a step took 6.5x longer (PERF.md)
    torch.backends.cudnn.benchmark = True
    cfg = _train_config("teacher", seed)
    session = TrainSession(cfg, ASSETS, device=DEVICE)
    loader = _loader(cfg, pool)
    row = {"phase": "train_teacher", "batch": cfg.data.batch_size,
           "crop": [cfg.data.image_height, cfg.data.image_width],
           "min_kept": cfg.min_kept(),
           "train_pre": ("native" if loader.preprocess.uses_native()
                         else "numpy")}
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        stats = session.train_epoch(loader, 0, TRAIN_NITERS)
        torch.cuda.synchronize()
        # the step is autograd over the plain network: no kernel of the
        # port has a backward, so none launches here
        row["step_launches"] = kernels.launch_counts()
        _finite_steps(stats, "train_teacher", kl=False)
        session.save(save_dir)
        row.update(losses=stats["losses"], train_mIoU=stats["train_mIoU"])
        row.update(_step_readings(session, loader,
                                  *_on_card(loader.make_batch(0, 0))))
    finally:
        loader.close()
    row["seconds"] = time.perf_counter() - t0
    row["gpu"] = gpu_line()
    emit(row)
    return row


def _card_against_cpu(session, pool, seed: int) -> dict:
    """One student step (batch 2, 256x512, full width) from the same
    weights, momentum-free optimizer and batch, on the card and on the CPU,
    in fp32 and in float64. Raises outside the bars of CARD_CPU_*; reports
    how far each device's fp32 step is from its own float64 step."""
    import torch
    from fasterseg_tpu_torch.train import TrainState, make_optimizer, train_step
    cfg = _train_config("student", seed, hw=(256, 512), batch=2)
    loader = _loader(cfg, pool)
    x, y = (torch.from_numpy(a) for a in loader.make_batch(0, 0))
    c = cfg
    kw = dict(session.step_kwargs, min_kept=c.min_kept())
    states, losses = {}, {}
    for name, device in (("card", DEVICE), ("cpu", "cpu")):
        for dtype in (torch.float32, torch.float64):
            net = copy.deepcopy(session.model).to(device=device, dtype=dtype)
            teacher = copy.deepcopy(session.teacher).to(device=device,
                                                        dtype=dtype)
            state = TrainState(net, make_optimizer(
                net.parameters(), c.lr, c.momentum, c.weight_decay,
                c.lr_decay, c.niters_per_epoch))
            m = train_step(state, x.to(device=device, dtype=dtype),
                           y.to(device), teacher, **kw)
            key = f"{name}{dtype.itemsize * 8}"
            losses[key] = float(m["loss"])
            states[key] = {k: v.detach().cpu().double()
                           for k, v in net.state_dict().items()
                           if v.is_floating_point()}
            del net, teacher, state

    def worst(a, b, atol, rtol):
        """(largest abs difference, its tensor, largest share of the bar,
        tensors over the bar) between two states."""
        out = [0.0, "", 0.0, 0]
        for k, w in states[b].items():
            err = (states[a][k] - w).abs()
            share = (err / (atol + rtol * w.abs())).max().item()
            out[:2] = max(out[:2], [err.max().item(), k])
            out[2] = max(out[2], share)
            out[3] += share > 1
        return out

    rel = abs(losses["card32"] - losses["cpu32"]) / abs(losses["cpu32"])
    check(rel <= CARD_CPU_RTOL, f"card vs CPU: loss {losses}")
    f64 = worst("card64", "cpu64", CARD_CPU_F64_ATOL, CARD_CPU_F64_RTOL)
    check(f64[3] == 0, f"card vs CPU in float64: {f64[1]} off by {f64[0]}")
    f32 = worst("card32", "cpu32", CARD_CPU_ATOL, CARD_CPU_RTOL)
    return {"shape": "2x256x512", "loss": losses, "loss_rel_err": rel,
            "f64_max_abs_err": f64[0], "f64_max_abs_err_tensor": f64[1],
            "max_abs_err": f32[0], "max_abs_err_tensor": f32[1],
            "worst_share_of_fp32_bar": f32[2], "tensors_over_fp32_bar": f32[3],
            "tensors": len(states["cpu32"]),
            "card_fp32_vs_fp64_max_abs": worst("card32", "card64", 1, 0)[0],
            "cpu_fp32_vs_fp64_max_abs": worst("cpu32", "cpu64", 1, 0)[0]}


def _resume_check(seed: int, pool, teacher_ckpt: str) -> dict:
    """2 epochs x 2 steps, save, restore into a new session, 2 more,
    against 4 epochs unbroken, at batch 2 and 128x256 crops, under
    torch.use_deterministic_algorithms (warnings of ops that have no
    deterministic form are recorded, not raised): the state_dict and the
    optimizer state must be equal bit for bit."""
    import torch
    from fasterseg_tpu_torch.train import TrainSession
    cfg = _train_config("student", seed, hw=(128, 256), batch=2)

    def run(epochs, save_dir=None, resume_dir=None):
        session = TrainSession(cfg, ASSETS, device=DEVICE)
        session.load_teacher_weights(teacher_ckpt)
        start = session.restore(resume_dir) if resume_dir else 0
        loader = _loader(cfg, pool)
        try:
            for epoch in range(start, epochs):
                session.train_epoch(loader, epoch, TRAIN_NITERS)
        finally:
            loader.close()
        if save_dir:
            session.save(save_dir, epochs - 1)
        return session, start

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, \
                tempfile.TemporaryDirectory() as tmp:
            warnings.simplefilter("always")
            unbroken, _ = run(4)
            run(2, save_dir=tmp)
            resumed, start = run(4, resume_dir=tmp)
    finally:
        torch.use_deterministic_algorithms(False)
    check(start == 2, f"resume: restore returned epoch {start}")
    check(unbroken.state.step == resumed.state.step == 4 * TRAIN_NITERS,
          "resume: update counts")
    a, b = unbroken.model.state_dict(), resumed.model.state_dict()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    oa = unbroken.state.optimizer.state_dict()
    ob = resumed.state.optimizer.state_dict()
    differ += [f"momentum {i}" for i in oa["state"]
               if not torch.equal(oa["state"][i]["momentum_buffer"],
                                  ob["state"][i]["momentum_buffer"])]
    check(oa["param_groups"] == ob["param_groups"], "resume: param groups")
    nondet = sorted({str(w.message).split(" does not have")[0][:120]
                     for w in caught if "deterministic" in str(w.message)})
    check(not differ, f"resume: {len(differ)} tensors differ, e.g. "
                      f"{differ[:3]}; ops without a deterministic form: "
                      f"{nondet}")
    return {"crop": "2x128x256", "epochs": "2 + resume 2 vs 4",
            "tensors_equal": len(a) + len(oa["state"]),
            "nondeterministic_ops_warned": nondet}


def phase_train_student(seed: int, pool, teacher_ckpt: str,
                        eval_scenes) -> dict:
    """Student mode at batch 12, 512x1024 from the teacher's checkpoint; the
    main path is two epochs through TrainSession.train_epoch and
    TrainSession.evaluate over the eval scenes (the conv kernels)."""
    import numpy as np
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.core import DataConfig
    from fasterseg_tpu_torch.eval import Evaluator
    from fasterseg_tpu_torch.models import InferenceRunner
    from fasterseg_tpu_torch.train import TrainSession, learning_rate
    t0 = time.perf_counter()
    cfg = _train_config("student", seed)
    session = TrainSession(cfg, ASSETS, device=DEVICE)
    res = session.load_teacher_weights(teacher_ckpt)
    check(not res.missing, f"teacher checkpoint lacks {res.missing[:3]}")
    row = {"phase": "train_student", "batch": cfg.data.batch_size,
           "crop": [cfg.data.image_height, cfg.data.image_width],
           "teacher_load": {"missing": len(res.missing),
                            "unexpected": len(res.unexpected),
                            "mismatched": len(res.mismatched)}}
    before = {k: v.clone() for k, v in session.model.state_dict().items()}
    loader = _loader(cfg, pool)
    group = session.state.optimizer.param_groups[0]
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        epochs, lrs = [], []
        for epoch in range(2):
            epochs.append(session.train_epoch(loader, epoch, TRAIN_NITERS))
            lrs.append(group["lr"])
            # the rate of the epoch's last update: 0.01 * 0.992^epoch
            want = cfg.lr * cfg.lr_decay ** epoch
            check(abs(group["lr"] - want) <= 1e-12 * want
                  and group["lr"] == learning_rate(group,
                                                   session.state.step - 1),
                  f"train_student: lr {group['lr']} after epoch {epoch}, "
                  f"want {want}")
        torch.cuda.synchronize()
        row["step_launches"] = kernels.launch_counts()
        for stats in epochs:
            _finite_steps(stats, "train_student", kl=True)
        row["losses"] = sum((s["losses"] for s in epochs), [])
        row["losses_kl"] = sum((s["losses_kl"] for s in epochs), [])
        row["lr_after_epochs"] = lrs
        after = session.model.state_dict()
        still = [k for k, v in after.items() if v.is_floating_point()
                 and torch.equal(v, before[k])]
        check(not still, f"train_student: {len(still)} tensors did not "
                         f"move, e.g. {still[:3]}")
        row["tensors_moved"] = sum(v.is_floating_point()
                                   for v in after.values())
        x, y = _on_card(loader.make_batch(0, 0))
        row.update(_step_readings(session, loader, x, y))
        # where a step's device time goes, by kernel name
        row["step_device"] = device_breakdown(lambda: session.step(x, y),
                                              frames=2, top=15)
        row["count_copies_ms"] = _count_copies_probe(y)
        del x, y
    finally:
        loader.close()
    losses = row["fixed_batch_losses"][:5]
    check(losses[-1] < losses[0],
          f"train_student: the loss did not fall on a fixed batch: {losses}")

    row["card_vs_cpu"] = _card_against_cpu(session, pool, seed)
    row["resume"] = _resume_check(seed, pool, teacher_ckpt)

    # the trained student evaluated through the conv kernels (fp32 runner)
    # against the plain fp32 network on the same Evaluator
    data = DataConfig()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ev_k = session.evaluate(eval_scenes)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    n = len(eval_scenes)
    check(launches["conv3x3_bn_relu_s1"] == 36 * n
          and launches["conv3x3_bn_relu_s2"] == 4 * n,
          f"train_student evaluate: conv launches {launches}")
    plain = InferenceRunner(session.plans[session.student_idx], session.model,
                            dtype=torch.float32, device=DEVICE,
                            fast_stem_enabled=False)
    ev_p = Evaluator(eval_scenes, data.num_classes, data.image_mean,
                     data.image_std, plain.logits,
                     ignore_label=data.ignore_label, device=DEVICE).run()
    d = _hist_d(ev_k.hist, ev_p.hist)
    check(int(ev_k.hist.sum()) == int(ev_p.hist.sum()) > 0,
          "train_student evaluate: hist sums")
    check(d <= EVAL_DIFF_FP32, f"train_student evaluate: d = {d}")
    row["evaluate"] = {"images": f"{n}x{HW[0]}x{HW[1]}", "launches": launches,
                       "d_kernels_vs_plain": d, "miou": ev_k.mean_iu,
                       "pixel_acc": ev_k.pixel_acc,
                       "plain_miou": ev_p.mean_iu}
    row["seconds"] = time.perf_counter() - t0
    row["gpu"] = gpu_line()
    emit(row)
    return row


# --------------------------------------------------------------- distributed


DIST_RANKS = 2                     # gloo ranks that share cuda:0
DIST_EVAL_SCENES = 5               # odd: the last global batch is padded
DIST_TIMED = 3                     # timed steps a session in bar (1)
SPATIAL_MULTI_SCENES = 2           # scenes of the spatial multi-scale bar
SPATIAL_SCALES = (0.75, 1.0, 1.25)


def _state(session) -> dict:
    """A TrainSession's parameters, BN statistics and momentum buffers, on
    the CPU."""
    opt = session.state.optimizer
    out = {k: v.detach().cpu().clone()
           for k, v in session.model.state_dict().items()}
    for name, p in session.model.named_parameters():
        if p in opt.state:
            out[f"momentum.{name}"] = opt.state[p]["momentum_buffer"].cpu()
    return out


def _largest_diff(a: dict, b: dict):
    """(largest |a - b| over the float tensors, its key, keys not equal bit
    for bit)."""
    import torch
    worst, key, differ = 0.0, "", []
    for k, v in a.items():
        if not torch.equal(v, b[k]):
            differ.append(k)
        if v.is_floating_point() and v.numel():
            e = float((v.double() - b[k].double()).abs().max())
            if e > worst:
                worst, key = e, k
    return worst, key, differ


def _timed_step(session, x, y) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    session.step(x, y)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _nccl_world_of_one(seed: int, pool) -> dict:
    """Bar (1): the shipped student and teacher at full width, batch 12 at
    512x1024, fp32, deterministic algorithms: one distill step of a session
    on an NCCL mesh of one rank equals the no-mesh session's step from the
    same state bit for bit (the world-1 merge of the BN moments, the
    reductions and the global OHEM head are exact). Then the step's time
    with and without the mesh, in turns, and the bytes it all-reduces."""
    import torch
    from fasterseg_tpu_torch.parallel import init_mesh
    from fasterseg_tpu_torch.train import TrainSession
    cfg = _train_config("student", seed)
    loader = _loader(cfg, pool)
    try:
        x, y = _on_card(loader.make_batch(0, 0))
    finally:
        loader.close()
    # as cli/train.py and the train phases run: autotuned convs (cuDNN's
    # heuristic fp32 choice made a step several times slower, PERF.md)
    torch.backends.cudnn.benchmark = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    mesh = None
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            mesh = init_mesh(0, 1, "nccl", DEVICE, os.path.join(tmp, "store"))
            plain = TrainSession(cfg, ASSETS, device=DEVICE)
            meshed = TrainSession(cfg, ASSETS, mesh=mesh)
            worst, _, differ = _largest_diff(_state(plain), _state(meshed))
            check(not differ, f"distributed (1): the sessions start apart "
                              f"({len(differ)} tensors)")
            m_plain = plain.step(x, y)
            before = mesh.bytes_reduced
            m_mesh = meshed.step(x, y)
            bytes_step = mesh.bytes_reduced - before
            a, b = _state(plain), _state(meshed)
            for k in ("loss", "loss_kl", "inter", "union"):
                a[k], b[k] = m_plain[k].cpu(), m_mesh[k].cpu()
            worst, key, differ = _largest_diff(a, b)
            times = {"no_mesh": [], "nccl_world_1": []}
            for turn in range(DIST_TIMED):
                for name in (("no_mesh", "nccl_world_1") if turn % 2 == 0
                             else ("nccl_world_1", "no_mesh")):
                    s = plain if name == "no_mesh" else meshed
                    times[name].append(_timed_step(s, x, y))
        finally:
            if mesh is not None:
                mesh.close()
            torch.use_deterministic_algorithms(False)
    check(not differ, f"distributed (1): the NCCL world-1 step differs from "
                      f"the no-mesh step at {len(differ)} tensors, largest "
                      f"|d| {worst} at {key}: the world-1 path must compute "
                      f"the same arithmetic")
    return {"model": "student (arch_1) + teacher (arch_0), full width",
            "batch": "12x512x1024 fp32, deterministic algorithms",
            "tensors_equal": len(a), "max_abs_diff": worst,
            "bytes_all_reduced_per_step": bytes_step,
            "step_ms": {k: {"median": statistics.median(v), "min": min(v),
                            "max": max(v), "reps": len(v)}
                        for k, v in times.items()},
            "loss": float(m_mesh["loss"])}


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _rank_float64_step(mesh, cfg, x, y) -> dict:
    """Bar (2), on a rank: the float64 distill step of a TrainSession on the
    mesh, on this rank's shard of (x, y); its state and its time."""
    import torch
    from fasterseg_tpu_torch.parallel import shard_batch
    from fasterseg_tpu_torch.train import TrainSession
    session = TrainSession(cfg, ASSETS, mesh=mesh)
    session.model.double()
    session.teacher.double()
    xs, ys = (t.to(mesh.device) for t in shard_batch((x.double(), y), mesh))
    before = mesh.bytes_reduced
    _sync(mesh.device)
    t0 = time.perf_counter()
    m = session.step(xs, ys)
    _sync(mesh.device)
    ms = (time.perf_counter() - t0) * 1e3
    state = _state(session)
    for k in ("loss", "loss_kl", "inter", "union"):
        state[k] = m[k].cpu()
    return {"state": state, "ms_host_clock": ms,
            "bytes": mesh.bytes_reduced - before}


def _rank_eval(mesh, seed: int, scenes, spatial: bool = False,
               scales=(1.0,), flip: bool = False) -> dict:
    """Bar (3), on a rank (or alone with mesh None): the student's fp32
    kernel path (seeded random weights, as eval_student's K32) through
    Evaluator, the launch counts read around that run alone; `spatial`
    splits each image over H across the mesh's ranks instead (S3, S4),
    with the exchanges it made."""
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.core import DataConfig
    from fasterseg_tpu_torch.eval import Evaluator
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan)
    from fasterseg_tpu_torch.utils import init_random_
    data = DataConfig()
    plan = student_plan()
    device = DEVICE if mesh is None else mesh.device
    runner = InferenceRunner(plan, init_random_(DerivedNet(plan), seed),
                             dtype=torch.float32, device=device)
    ev = Evaluator(scenes, plan.num_classes, data.image_mean, data.image_std,
                   runner.logits, eval_scales=scales, eval_flip=flip,
                   ignore_label=data.ignore_label, device=device, mesh=mesh,
                   spatial=spatial)
    _sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = ev.run()
    _sync(device)
    out = {"hist": res.hist, "launches": kernels.launch_counts(),
           "halo_launches": kernels.halo_launch_counts(),
           "seconds": time.perf_counter() - t0}
    if spatial:
        out.update(exchanges=ev.exchange.exchanges, bytes=ev.exchange.bytes)
    return out


def _rank_spatial(mesh, seed: int, scenes) -> dict:
    """(S2)-(S5) on a rank of the spatial mesh (the same gloo ranks): the
    student (seeded random weights, as serve_student) at 1024x2048, its
    logits of this rank's block of the seeded image in fp32 and bf16 with
    the counts, exchanges and bytes of that forward, against this process's
    unsplit `logits` of the whole image (fp32: the largest distance; bf16:
    the class-map agreement and this block's class map); then Evaluator
    split over H over the scenes (S3) and, at SPATIAL_SCALES with the flip,
    over the first SPATIAL_MULTI_SCENES (S4)."""
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan)
    from fasterseg_tpu_torch.parallel import SPATIAL_AXIS, make_mesh
    from fasterseg_tpu_torch.parallel.spatial import Block, Exchange, partition
    from fasterseg_tpu_torch.utils import init_random_
    mesh = make_mesh(mesh.world, axis_names=(SPATIAL_AXIS,),
                     device=mesh.device)
    plan = student_plan()
    net = init_random_(DerivedNet(plan), seed)
    x = _seeded_image(seed + 1).to(mesh.device)
    out = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        runner = InferenceRunner(plan, net, dtype=dtype, device=mesh.device)
        part = partition(HW[0], mesh.world, runner.row_multiple)
        lo, hi = part.block(mesh.rank)
        xb = x[:, lo:hi].contiguous()
        runner.logits(Block(xb, part, Exchange(mesh)))   # warm-up
        ex = Exchange(mesh)
        _sync(mesh.device)
        # the spatial forward: the counts are 0 just before, read just after
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = runner.logits(Block(xb, part, ex)).t
        _sync(mesh.device)
        r = {"rows": [lo, hi], "bounds": list(part.bounds),
             "forward_ms_host_clock": (time.perf_counter() - t0) * 1e3,
             "launches": kernels.launch_counts(),
             "halo_launches": kernels.halo_launch_counts(),
             "exchanges": ex.exchanges, "bytes": ex.bytes}
        whole = runner.logits(x)[:, lo:hi]
        if dtype == torch.float32:
            r["max_abs_err"] = (got - whole).abs().max().item()
            r["max_abs_logit"] = whole.abs().max().item()
        else:
            cm = torch.argmax(got.float(), -1).int()
            r["agree_unsplit"] = (cm == torch.argmax(whole.float(), -1)
                                  .int()).float().mean().item()
            r["classmap"] = cm.cpu()
        del got, whole
        out[name] = r
    out["eval"] = _rank_eval(mesh, seed, scenes, spatial=True)
    out["eval_multi"] = _rank_eval(mesh, seed, scenes[:SPATIAL_MULTI_SCENES],
                                   spatial=True, scales=SPATIAL_SCALES,
                                   flip=True)
    return out


def _tiny_search_engine(seed: int, batch: int, device, mesh=None):
    """The search phase's float64 card-vs-CPU engine: 5 layers, Fch 8, five
    widths, teacher and student, a global batch of `batch` at 64x128,
    priced by `_standin_ms`."""
    from fasterseg_tpu_torch.core.config import (DataConfig,
                                                 cityscapes_search_config)
    from fasterseg_tpu_torch.latency import LatencyLUT
    from fasterseg_tpu_torch.parallel import dryrun
    cfg = cityscapes_search_config(seed=seed, layers=5, Fch=8, data=DataConfig(
        gt_down_sampling=8, down_sampling=2, image_height=64,
        image_width=128, batch_size=batch))
    return dryrun.tiny_engine(cfg, device, mesh,
                              lut=LatencyLUT(provider=_standin_ms))


def _rank_search_step(mesh, seed: int) -> dict:
    """Bar (4), on a rank: one arch step and one weight step of the tiny
    engine on the mesh, on this rank's shard."""
    from fasterseg_tpu_torch.parallel import dryrun
    engine = _tiny_search_engine(seed, 4, mesh.device, mesh)
    x, y = dryrun.global_batch(seed, 4, (64, 128), (8, 16))
    return dryrun.search_step(engine, x, y, mesh)


def _dist_ranks(mesh, seed, cfg64, x64, y64, scenes) -> dict:
    """Bars (2)-(5) on one rank of the gloo mesh on cuda:0 (one spawn: a
    rank takes ~10 s to reach the card); (5) is the dry run's rank body,
    which holds its steps against one rank itself."""
    import torch
    from fasterseg_tpu_torch.parallel import dryrun
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"float64_step": _rank_float64_step(mesh, cfg64, x64, y64),
           "eval": _rank_eval(mesh, seed, scenes),
           "spatial": _rank_spatial(mesh, seed, scenes),
           "search": _rank_search_step(mesh, seed)}
    t0 = time.perf_counter()
    out["dryrun"] = dryrun.run_steps(mesh, seed)
    out["dryrun_s"] = time.perf_counter() - t0
    return out


SPATIAL_LOGITS_BAR = 1e-4          # spatial vs unsplit fp32 logits: the
                                   # fp32 kernel bar


def _same_hist(what: str, hists, one, one_repeats: bool) -> dict:
    """Bar (3) of the distributed phase, for the ranks' hists against the
    one-rank run's: identical, or within d <= EVAL_DIFF_FP32 if that run
    does not repeat itself bit for bit."""
    import numpy as np
    identical = all(np.array_equal(h, one) for h in hists)
    d = max(_hist_d(h, one) for h in hists)
    if one_repeats:
        check(identical, f"{what}: the ranks' hist is {d} from the one-rank "
                         f"kernel run, which repeats bit for bit")
    else:
        check(d <= EVAL_DIFF_FP32, f"{what}: d = {d} > {EVAL_DIFF_FP32} (the "
                                   f"one-rank run does not repeat)")
    return {"hist_identical": identical, "d": d,
            "one_rank_repeats_bit_for_bit": one_repeats}


def _spatial_bars(seed: int, sp, data_one, one_repeats: bool,
                  scenes) -> dict:
    """(S2)-(S5) from the ranks' `_rank_spatial` results `sp`, against one
    process: (S2) fp32 spatial logits within SPATIAL_LOGITS_BAR of the
    unsplit forward's, halo-mode launches on every rank; (S3) the spatial
    evaluation's hist against bar (3)'s one-rank run; (S4) the same at
    SPATIAL_SCALES + flip against a one-rank run here; (S5) the bf16
    spatial class map against the unsplit bf16 one and the plain fp32 one,
    each no worse than the plain bf16 path's agreement with plain fp32 less
    NOISE_FLOOR_MARGIN (the serving rule). Readings: exchanges and bytes a
    forward, ms per image split over two ranks and on one."""
    import torch
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan)
    from fasterseg_tpu_torch.utils import init_random_
    err = max(s["fp32"]["max_abs_err"] for s in sp)
    check(err <= SPATIAL_LOGITS_BAR,
          f"spatial (S2): logits {err} from the unsplit forward's")
    # (rank 0's block starts at the image's top: its stride-2 convs read
    # no halo, their blocks being of even height)
    for what in ("fp32", "bf16", "eval", "eval_multi"):
        for r, s in enumerate(sp):
            check(sum(s[what]["halo_launches"].values()) > 0,
                  f"spatial {what}: rank {r} launched no conv in halo mode")
    s3 = _same_hist("spatial (S3)", [s["eval"]["hist"] for s in sp],
                    data_one["hist"], one_repeats)
    multi = scenes[:SPATIAL_MULTI_SCENES]
    kw = dict(scales=SPATIAL_SCALES, flip=True)
    multi_one = _rank_eval(None, seed, multi, **kw)
    s4 = _same_hist("spatial (S4)", [s["eval_multi"]["hist"] for s in sp],
                    multi_one["hist"],
                    bool((_rank_eval(None, seed, multi, **kw)["hist"]
                          == multi_one["hist"]).all()))
    plan = student_plan()
    net = init_random_(DerivedNet(plan), seed)
    x = _seeded_image(seed + 1).to(DEVICE)
    plain = {dtype: InferenceRunner(plan, net, dtype=dtype, device=DEVICE,
                                    fast_stem_enabled=False).classmap(x).cpu()
             for dtype in (torch.float32, torch.bfloat16)}
    floor = ((plain[torch.bfloat16] == plain[torch.float32]).float().mean()
             .item() - NOISE_FLOOR_MARGIN)
    cm = torch.cat([s["bf16"]["classmap"] for s in sp], dim=1)
    rows = [s["bf16"]["rows"][1] - s["bf16"]["rows"][0] for s in sp]
    agree_unsplit = sum(s["bf16"]["agree_unsplit"] * n
                        for s, n in zip(sp, rows)) / sum(rows)
    agree_fp32 = (cm == plain[torch.float32]).float().mean().item()
    check(agree_unsplit >= floor and agree_fp32 >= floor,
          f"spatial (S5): the bf16 spatial class map agrees on "
          f"{agree_unsplit} with the unsplit bf16 one and {agree_fp32} with "
          f"plain fp32, below the bf16 plain path's floor {floor}")
    per_image = lambda sec, n: sec / n * 1e3
    return {
        "model": "student (arch_1), seeded random weights, 1024x2048",
        "bounds": sp[0]["fp32"]["bounds"],
        "logits_fp32": {"max_abs_err": err, "bar": SPATIAL_LOGITS_BAR,
                        "max_abs_logit": sp[0]["fp32"]["max_abs_logit"]},
        "exchanges_per_forward": [s["fp32"]["exchanges"] for s in sp],
        "bytes_per_forward_fp32": [s["fp32"]["bytes"] for s in sp],
        "bytes_per_forward_bf16": [s["bf16"]["bytes"] for s in sp],
        "forward_launches_per_rank": [s["fp32"]["launches"] for s in sp],
        "forward_halo_launches_per_rank": [s["fp32"]["halo_launches"]
                                           for s in sp],
        "forward_ms_host_clock": {d: [s[d]["forward_ms_host_clock"]
                                      for s in sp] for d in ("fp32", "bf16")},
        "eval": {**s3, "images": f"{len(scenes)}x{HW[0]}x{HW[1]}",
                 "launches_per_rank": [s["eval"]["launches"] for s in sp],
                 "halo_launches_per_rank": [s["eval"]["halo_launches"]
                                            for s in sp],
                 "exchanges_per_rank": [s["eval"]["exchanges"] for s in sp],
                 "ms_per_image_spatial": [per_image(s["eval"]["seconds"],
                                                    len(scenes)) for s in sp],
                 "ms_per_image_one_rank": per_image(data_one["seconds"],
                                                    len(scenes))},
        "eval_multi_flip": {
            **s4, "images": f"{len(multi)}x{HW[0]}x{HW[1]}",
            "scales": list(SPATIAL_SCALES),
            "halo_launches_per_rank": [s["eval_multi"]["halo_launches"]
                                       for s in sp],
            "ms_per_image_spatial": [per_image(s["eval_multi"]["seconds"],
                                               len(multi)) for s in sp],
            "ms_per_image_one_rank": per_image(multi_one["seconds"],
                                               len(multi))},
        "bf16": {"agree_unsplit_bf16": agree_unsplit,
                 "agree_plain_fp32": agree_fp32, "floor": floor}}


def phase_distributed(seed: int, pool, eval_scenes) -> dict:
    """Data parallelism on the card: (1) the full-width distill step on an
    NCCL mesh of one rank against the session without a mesh; two gloo
    ranks on cuda:0 for (2) the float64 student step (256x512, batch 4),
    (3) Evaluator through the conv kernels over 5 scenes at 1024x2048 and
    (4) the tiny search step in float64, each against one rank; (5) the
    dry run's steps on the same two ranks."""
    import numpy as np
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.data.procgen import ProcCity
    from fasterseg_tpu_torch.parallel import dryrun, launch
    from fasterseg_tpu_torch.train import TrainSession
    t0 = time.perf_counter()
    row = {"phase": "distributed", "gpu": gpu_line()}
    row["nccl_world_1"] = _nccl_world_of_one(seed, pool)

    cfg64 = _train_config("student", seed, hw=(256, 512), batch=4)
    loader = _loader(cfg64, pool)
    try:
        x64, y64 = (torch.from_numpy(a) for a in loader.make_batch(0, 0))
    finally:
        loader.close()
    scenes = list(eval_scenes) + [
        ProcCity(length=DIST_EVAL_SCENES, hw=HW, seed=seed, split="val")[i]
        for i in range(len(eval_scenes), DIST_EVAL_SCENES)]
    t1 = time.perf_counter()
    ranks = launch(_dist_ranks, DIST_RANKS, "gloo",
                   [DEVICE + ":0"] * DIST_RANKS,
                   args=(seed, cfg64, x64, y64, scenes))
    launch_s = time.perf_counter() - t1

    # (2) the float64 step against one rank
    session = TrainSession(cfg64, ASSETS, device=DEVICE)
    session.model.double()
    session.teacher.double()
    _sync(DEVICE)
    t1 = time.perf_counter()
    m = session.step(x64.double().to(DEVICE), y64.to(DEVICE))
    _sync(DEVICE)
    one_ms = (time.perf_counter() - t1) * 1e3
    want = _state(session)
    for k in ("loss", "loss_kl", "inter", "union"):
        want[k] = m[k].cpu()
    del session
    got = [{"state": r["float64_step"]["state"], "metrics": {}}
           for r in ranks]
    cmp = [dryrun.compare(g, {"state": want, "metrics": {}}) for g in got]
    same = not _largest_diff(got[0]["state"], got[1]["state"])[2]
    check(all(not c["over"] for c in cmp) and same,
          f"distributed (2): the two-rank float64 step is off the one-rank "
          f"step at {[c['over'][:3] for c in cmp]}, worst "
          f"{[c['max_abs_err'] for c in cmp]}; ranks equal: {same}")
    row["gloo_float64_step"] = {
        "model": "student + teacher, full width", "batch": "4x256x512 float64",
        "tensors": len(want), "max_abs_err": max(c["max_abs_err"]
                                                 for c in cmp),
        "ranks_equal": same,
        "rank_step_ms_host_clock": [r["float64_step"]["ms_host_clock"]
                                    for r in ranks],
        "one_rank_step_ms_host_clock": one_ms,
        "bytes_all_reduced_per_step": ranks[0]["float64_step"]["bytes"]}

    # (3) the evaluator through the kernels against one rank
    data_one = _rank_eval(None, seed, scenes)
    repeat = _rank_eval(None, seed, scenes)
    repeatable = np.array_equal(repeat["hist"], data_one["hist"])
    bar3 = _same_hist("distributed (3)", [r["eval"]["hist"] for r in ranks],
                      data_one["hist"], repeatable)
    for name in ("conv3x3_bn_relu_s1", "conv3x3_bn_relu_s2"):
        counts = [r["eval"]["launches"][name] for r in ranks]
        check(all(c > 0 for c in counts)
              and sum(counts) == data_one["launches"][name],
              f"distributed (3): {name} launches {counts} on the ranks, "
              f"{data_one['launches'][name]} on one")
    row["gloo_eval"] = {
        "images": f"{DIST_EVAL_SCENES}x{HW[0]}x{HW[1]}", "forward": "K32",
        **bar3,
        "launches_per_rank": [r["eval"]["launches"] for r in ranks],
        "launches_one_rank": data_one["launches"],
        "seconds_per_rank": [r["eval"]["seconds"] for r in ranks],
        "seconds_one_rank": data_one["seconds"]}
    row["spatial"] = _spatial_bars(seed, [r["spatial"] for r in ranks],
                                   data_one, repeatable, scenes)

    # (4) the tiny search step against one rank
    x, y = dryrun.global_batch(seed, 4, (64, 128), (8, 16))
    want = dryrun.search_step(_tiny_search_engine(seed, 4, DEVICE), x, y)
    cmp = [dryrun.compare(r["search"], want, exact_keys=("loss_latency",))
           for r in ranks]
    same = not _largest_diff(ranks[0]["search"]["state"],
                             ranks[1]["search"]["state"])[2]
    check(all(not c["over"] for c in cmp) and same,
          f"distributed (4): the two-rank search step is off one rank at "
          f"{[c['over'][:3] for c in cmp]}; ranks equal: {same}")
    row["gloo_search_step"] = {
        "size": "5 layers, Fch 8, 4x64x128, float64",
        "tensors": len(want["state"]),
        "max_abs_err": max(c["max_abs_err"] for c in cmp),
        "ranks_equal": same}
    row["gloo_launch_s"] = launch_s

    # (5) the dry run's steps at two ranks on the card (run_steps raised on
    # a rank whose step missed the one-rank step's bars)
    row["dryrun"] = {"ranks": DIST_RANKS, "device": DEVICE + ":0",
                     "seconds": ranks[0]["dryrun_s"],
                     **{name: {k: ranks[0]["dryrun"][name][k] for k in
                               ("loss", "max_abs_err", "bytes_all_reduced",
                                "same_on_ranks")}
                        for name in ("distill", "search")}}
    kernels.reset_launch_counts()
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


# -------------------------------------------------------------------- search


SEARCH_POOL = 8                    # ProcCity scenes at 512x1024 (the x2
                                   # down-sampled frames search crops)
# steps an epoch in the search phase, each timed (a search step issues
# ~670 k launches and takes ~20 s, PERF.md); the one step includes cuDNN's
# autotuning, a small share: in an earlier run a pretrain epoch of two
# steps took 25.0 s where a later step took 12.0 s (PERF.md)
SEARCH_NITERS = 1
VAL_HW = (512, 1024)               # SearchConfig's eval size


def _standin_ms(key: str) -> float:
    """A stand-in latency (a product of the key's sizes) for the tiny
    card-vs-CPU check, whose Fch 8 keys the reference's table lacks; both
    devices read the same table, so only equality matters there."""
    from fasterseg_tpu_torch.latency.lut import parse_key
    _, f = parse_key(key)
    size = f.get("H", 1) * f.get("W", 1) * f.get("Cin", f.get("C", 1)) \
        * f.get("Cout", 1) * f.get("kernel", 3) ** 2
    return 0.01 + 1e-9 * size / f.get("stride", 1) ** 2


def _search_configs(seed: int):
    """The repo's SearchConfig (16 layers, Fch 12, five widths, teacher and
    student, reference LUT priced at 1024x2048): pretrain at batch 3 and
    256x512 crops, search at batch 2 and 224x448."""
    from fasterseg_tpu_torch.core.config import (DataConfig,
                                                 cityscapes_pretrain_config,
                                                 cityscapes_search_config)
    pre = cityscapes_pretrain_config(seed=seed, data=DataConfig(
        gt_down_sampling=8, down_sampling=2, image_height=256,
        image_width=512, batch_size=3))
    return pre, cityscapes_search_config(seed=seed)


def _search_pool(seed: int):
    from concurrent.futures import ThreadPoolExecutor
    from fasterseg_tpu_torch.data.procgen import ProcCity
    scenes = ProcCity(length=SEARCH_POOL, hw=VAL_HW, seed=seed + 7,
                      split="train")
    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(scenes.__getitem__, range(SEARCH_POOL)))


def _loader_ms(loader) -> float:
    """The loader's ms per batch alone (host, median of 3)."""
    times = []
    for step in range(3):
        t0 = time.perf_counter()
        loader.make_batch(99, step)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def _step_times(engine):
    """Inside it, each `arch_step` and `weight_step` the engine makes is
    timed by CUDA events (ms, in order, under the method's name), and the
    peak memory counter starts from 0."""
    import torch
    times = {"arch_step": [], "weight_step": []}

    def timed(name, fn):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
            return out
        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in times:
        setattr(engine, name, timed(name, getattr(engine, name)))
    try:
        yield times
    finally:
        for name in times:
            delattr(engine, name)


def _search_step_readings(times, batch: int) -> dict:
    """ms of each step of an epoch (an arch step's and a weight step's sum
    where both ran), the last one's images/s, and the peak memory over
    them."""
    import torch
    steps = [a + w for a, w in zip(times["arch_step"], times["weight_step"])
             ] if times["arch_step"] else list(times["weight_step"])
    return {"step_ms": {"per_step": steps, "last": steps[-1]},
            "images_per_s": batch / steps[-1] * 1e3,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30}


def _arch_tensors(engine):
    return [(f"arch{idx}.{name}", t) for idx, ap in sorted(
        engine.arch_params.items()) for name, t in zip(
        ("alpha0", "alpha1", "alpha2", "beta1", "beta2", "ratio0",
         "ratio1", "ratio2"), ap.tensors())]


def _same(a, b, where: str = "") -> list:
    """Paths at which two nested payloads (dicts, lists, tensors, numbers)
    differ; tensors are compared bit for bit."""
    import torch
    if isinstance(a, torch.Tensor):
        return [] if (isinstance(b, torch.Tensor) and a.shape == b.shape
                      and torch.equal(a.cpu(), b.cpu())) else [where]
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [where]
        return sum((_same(a[k], b[k], f"{where}/{k}") for k in a), [])
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [where]
        return sum((_same(x, y, f"{where}/{i}")
                    for i, (x, y) in enumerate(zip(a, b))), [])
    return [] if a == b else [where]


def _tensor_count(tree) -> int:
    import torch
    if isinstance(tree, torch.Tensor):
        return 1
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_count(v) for v in tree)
    return 0


def _search_card_vs_cpu(seed: int, pool) -> dict:
    """One arch step and one weight step of search at a tiny size (5
    layers, Fch 8, batch 2 at 64x128) in float64, from one state and the
    same draws, on the card and on the CPU: every tensor of the supernet
    and every arch tensor within atol 1e-10 + rtol 1e-8."""
    import torch
    from fasterseg_tpu_torch.core.config import DataConfig
    from fasterseg_tpu_torch.data import TrainLoader, TrainPre
    from fasterseg_tpu_torch.search import draw_noise, to_device
    d = DataConfig()
    loader = TrainLoader(pool, TrainPre(d.image_mean, d.image_std, (64, 128),
                                        d.train_scale_array, 8,
                                        d.ignore_label), 2, seed=seed)
    x, y = (torch.from_numpy(a) for a in loader.make_batch(0, 0))
    loader.close()
    gen = torch.Generator().manual_seed(seed)
    out, seconds = {}, {}
    noise = None
    for name, device in (("cpu", "cpu"), ("card", DEVICE)):
        t0 = time.perf_counter()
        engine = _tiny_search_engine(seed, 2, device)
        if noise is None:     # drawn once, on the host, for both devices
            fw = engine.forwards(False)
            noise = (engine.draw_noise(fw, gen), {
                idx: draw_noise(ap.ratios, engine.prun_modes[idx], engine.nw,
                                gen)
                for idx, ap in engine.arch_params.items()},
                engine.draw_noise(fw, gen))
        n = to_device(noise, torch.device(device))
        xd, yd = x.double().to(device), y.to(device)
        am = engine.arch_step(xd, yd, noise=n[0], latency_noise=n[1])
        loss = engine.weight_step(xd, yd, False, noise=n[2])
        out[name] = ({k: v.detach().cpu() for k, v in
                      engine.model.state_dict().items()
                      if v.is_floating_point()},
                     {k: t.detach().cpu() for k, t in _arch_tensors(engine)},
                     {k: float(v) for k, v in am.items()}, float(loss))
        seconds[name] = time.perf_counter() - t0
        del engine
    worst, over = [0.0, ""], []
    for part in (0, 1):
        for k, want in out["cpu"][part].items():
            got = out["card"][part][k]
            err = (got - want).abs()
            worst = max(worst, [err.max().item(), k])
            if bool((err > CARD_CPU_F64_ATOL
                     + CARD_CPU_F64_RTOL * want.abs()).any()):
                over.append(k)
    for k, v in out["cpu"][2].items():
        check(abs(out["card"][2][k] - v) <= CARD_CPU_F64_RTOL * abs(v),
              f"search card vs CPU: {k} {out['card'][2][k]} vs {v}")
    check(abs(out["card"][3] - out["cpu"][3]) <= CARD_CPU_F64_RTOL
          * abs(out["cpu"][3]), f"search card vs CPU: loss {out['card'][3]}"
          f" vs {out['cpu'][3]}")
    check(not over, f"search card vs CPU in float64: {len(over)} tensors "
                    f"over the bar, e.g. {over[:3]}; worst {worst}")
    return {"size": "5 layers, Fch 8, 2x64x128, float64",
            "tensors": len(out["cpu"][0]) + len(out["cpu"][1]),
            "max_abs_err": worst[0], "max_abs_err_tensor": worst[1],
            "losses": {"card": [out["card"][2]["loss_arch"], out["card"][3]],
                       "cpu": [out["cpu"][2]["loss_arch"], out["cpu"][3]]},
            "seconds": seconds}


def _searched_plan(engine, lasts):
    """The engine's student decoded (numpy_arch -> decode_network ->
    build_plan) at branches `lasts`."""
    from fasterseg_tpu_torch.core.genotype import decode_network
    from fasterseg_tpu_torch.core.plan import build_plan
    c = engine.config
    genos = decode_network(engine.numpy_arch(1), engine.wml, c.layers,
                           ignore_skip=False)
    return build_plan(genos, lasts, Fch=c.Fch, num_classes=c.num_classes,
                      stem_head_width=c.stem_head_width[1])


def _decoded_student(plan, seed: int, eval_scenes, what: str = "search",
                     bf16: bool = False) -> dict:
    """A decoded student (DerivedNet of `plan` with seeded random weights)
    run through the kernels in fp32: Evaluator over the eval scenes and one
    class map, against the plain fp32 net; with `bf16`, also a bf16 class
    map held to the serving phases' rule (`_agreement`)."""
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.core import DataConfig
    from fasterseg_tpu_torch.data.preprocess import eval_preprocess
    from fasterseg_tpu_torch.eval import Evaluator
    from fasterseg_tpu_torch.models import DerivedNet, InferenceRunner
    from fasterseg_tpu_torch.utils import init_random_
    data = DataConfig()
    lasts = list(plan.lasts)
    net = init_random_(DerivedNet(plan), seed)
    kern = InferenceRunner(plan, net, dtype=torch.float32, device=DEVICE)
    plain = InferenceRunner(plan, net, dtype=torch.float32, device=DEVICE,
                            fast_stem_enabled=False)
    x = torch.from_numpy(eval_preprocess(
        eval_scenes[0]["data"], data.image_mean, data.image_std)[None]
    ).to(DEVICE)
    ev = lambda fwd: Evaluator(eval_scenes, plan.num_classes,
                               data.image_mean, data.image_std, fwd,
                               ignore_label=data.ignore_label, device=DEVICE)
    k16 = (InferenceRunner(plan, net, dtype=torch.bfloat16, device=DEVICE)
           if bf16 else None)
    # the main path: the counts are 0 just before and read just after
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res_k = ev(kern.logits).run()
    cm = kern.classmap(x)
    cm16 = k16.classmap(x) if bf16 else None
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for k, n in launches.items():
        check(n > 0, f"{what}: decoded student: kernel {k} was not "
                     f"launched")
    res_p = ev(plain.logits).run()
    d = _hist_d(res_k.hist, res_p.hist)
    check(int(res_k.hist.sum()) == int(res_p.hist.sum()) > 0,
          f"{what}: decoded student: hist sums")
    check(d <= EVAL_DIFF_FP32, f"{what}: decoded student: d = {d}")
    agree = (cm == plain.classmap(x)).float().mean().item()
    check(agree >= AGREE_FP32,
          f"{what}: decoded student class map agrees on {agree}")
    row = {"lasts": lasts, "ops": [list(g.ops) for g in plan.genotypes],
           "widths": [list(g.widths) for g in plan.genotypes],
           "num_classes": plan.num_classes,
           "images": f"{len(eval_scenes)}x{HW[0]}x{HW[1]}",
           "launches": launches, "d_kernels_vs_plain": d,
           "classmap_agree_fp32_kernels_vs_plain": agree,
           "miou": res_k.mean_iu}
    if bf16:
        del k16
        row["bf16"] = _agreement(f"{what}: decoded student", plan, net, x,
                                 cm16)
    return row


def phase_search(seed: int, eval_scenes, profile: bool = False) -> dict:
    """Supernet pretrain and bi-level search at the repo's SearchConfig on
    the card (fp32, cuDNN autotuned): SearchEngine.train_epoch for a
    pretrain epoch and a search epoch on ProcCity loaders, validate,
    arch_fps from the reference LUT, the decoded searched student through
    the kernels, save and restore. `profile`: the remat-off step under the
    profiler."""
    import math
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.core.plan import select_lasts
    from fasterseg_tpu_torch.data import TrainLoader, TrainPre
    from fasterseg_tpu_torch.data.procgen import ProcCity
    from fasterseg_tpu_torch.search import (SearchEngine, draw_noise,
                                            latency_terms, to_device)
    t0 = time.perf_counter()
    torch.backends.cudnn.benchmark = True
    cfg_pre, cfg = _search_configs(seed)
    pool = _search_pool(seed)
    half = SEARCH_POOL // 2

    def loader(c, scenes):
        d = c.data
        return TrainLoader(scenes, TrainPre(
            d.image_mean, d.image_std, (d.image_height, d.image_width),
            d.train_scale_array, d.gt_down_sampling, d.ignore_label),
            d.batch_size, seed=c.seed)

    def batch(ld):
        return to_device(tuple(torch.from_numpy(a) for a in
                               ld.make_batch(0, 0)), torch.device(DEVICE))

    row = {"phase": "search", "layers": cfg.layers, "Fch": cfg.Fch,
           "widths": len(cfg.width_mult_list),
           "nproc": os.cpu_count(), "part_seconds": {}}
    mark = [time.perf_counter()]

    def part(name):
        """Seconds since the previous part ended, under `name`."""
        now = time.perf_counter()
        row["part_seconds"][name] = now - mark[0]
        mark[0] = now

    # ---- pretrain: a weight step's four sandwich forwards on arch 0
    t1 = time.perf_counter()
    engine = SearchEngine(cfg_pre, device=DEVICE)
    row["params"] = sum(p.numel() for p in engine.model.parameters())
    row["engine_build_s"] = time.perf_counter() - t1
    ld = loader(cfg_pre, pool[:half])
    before = {k: v.clone() for k, v in engine.model.state_dict().items()}
    arch_before = [t.detach().clone() for _, t in _arch_tensors(engine)]
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        te = time.perf_counter()
        with _step_times(engine) as times:
            stats = engine.train_epoch(ld, None, 0, True, False,
                                       SEARCH_NITERS)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - te
        launches = kernels.launch_counts()
        check(all(math.isfinite(v) for v in stats["losses"]),
              f"search pretrain: losses {stats['losses']}")
        convs = [k for k, v in engine.model.named_parameters() if v.ndim == 4]
        after = engine.model.state_dict()
        still = [k for k in convs if torch.equal(after[k], before[k])]
        check(not still, f"search pretrain: {len(still)} conv weights did "
                         f"not move, e.g. {still[:3]}")
        check(all(torch.equal(a, t) for a, (_, t) in
                  zip(arch_before, _arch_tensors(engine))),
              "search pretrain: arch parameters moved")
        row["pretrain"] = {
            "batch": cfg_pre.data.batch_size,
            "crop": [cfg_pre.data.image_height, cfg_pre.data.image_width],
            "losses": stats["losses"], "step_launches": launches,
            "epoch_seconds": epoch_s, "conv_weights_moved": len(convs),
            **_search_step_readings(times, cfg_pre.data.batch_size),
            "loader_ms_per_batch": _loader_ms(ld),
            "loader_pool": ld.pool_size}
    finally:
        ld.close()
    del engine, before
    torch.cuda.empty_cache()
    part("pretrain")

    # ---- search: an arch step and a weight step a step, two loaders
    engine = SearchEngine(cfg, device=DEVICE)
    lw, la = loader(cfg, pool[:half]), loader(cfg, pool[half:])
    arch_before = [t.detach().clone() for _, t in _arch_tensors(engine)]
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        te = time.perf_counter()
        with _step_times(engine) as times:
            stats = engine.train_epoch(lw, la, 0, False, True, SEARCH_NITERS)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - te
        readings = _search_step_readings(times, cfg.data.batch_size)
        launches = kernels.launch_counts()
        for k in ("loss", "loss_arch", "loss_latency",
                  "latency_supernet_ms"):
            check(math.isfinite(stats[k]), f"search: {k} {stats[k]}")
        check(stats["loss_latency"] > 0,
              f"search: loss_latency {stats['loss_latency']}")
        moved = {name: not torch.equal(a, t) for a, (name, t) in
                 zip(arch_before, _arch_tensors(engine))}
        # the teacher's ratio logits are 1 wide: their softmax is constant,
        # so they get no gradient and Adam leaves them where they are
        fixed = {f"arch0.ratio{s}" for s in range(3)}
        wrong = [k for k, m in moved.items() if m == (k in fixed)]
        check(not wrong, f"search: arch tensors moved wrongly: {wrong}")

        # loss_latency against the estimator on the same draws
        xa, ya = batch(la)
        gen = torch.Generator().manual_seed(seed + 1)
        noise = engine.draw_noise(engine.forwards(False), gen)
        lat_noise = {idx: draw_noise(ap.ratios, engine.prun_modes[idx],
                                     engine.nw, gen)
                     for idx, ap in engine.arch_params.items()}
        noise, lat_noise = to_device((noise, lat_noise),
                                     torch.device(DEVICE))
        pins = [engine.model.width_pins(i) for i in range(2)]
        with torch.no_grad():
            lats = latency_terms(engine.tables, engine.stem_ms,
                                 engine.arch_params, cfg.layers, engine.nw,
                                 engine.prun_modes, [p[0] for p in pins],
                                 [p[1] for p in pins], noise=lat_noise)
            want = sum(w * float(lats[i]) for i, w in
                       enumerate(engine.controller.weights))
        am = engine.arch_step(xa, ya, noise=noise, latency_noise=lat_noise)
        got = float(am["loss_latency"])
        check(got > 0 and abs(got - want) <= 1e-6 * want,
              f"search: loss_latency {got} vs the estimator's {want}")

        x, y = batch(lw)
        gen = torch.Generator().manual_seed(seed + 2)

        def search_step():
            engine.arch_step(xa, ya, gen)
            engine.weight_step(x, y, False, gen)

        row["search"] = {
            "batch": cfg.data.batch_size,
            "crop": [cfg.data.image_height, cfg.data.image_width],
            "losses": stats["losses"], "loss_arch": stats["loss_arch"],
            "loss_latency": stats["loss_latency"],
            "latency_supernet_ms": stats["latency_supernet_ms"],
            "loss_latency_vs_estimator": [got, want],
            "step_launches": launches, "arch_moved": moved,
            "epoch_seconds": epoch_s, **readings,
            "loader_ms_per_batch": {"weight": _loader_ms(lw),
                                    "arch": _loader_ms(la)}}
        # one step with remat off: its peak memory beside the timed steps'
        # (remat on); with `profile`, under the profiler (where a step's time
        # goes: sorting its ~500 k kernel events takes the host minutes)
        engine.model.remat = False
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if profile:
            row["search"]["step_device_remat_off"] = device_breakdown(
                search_step, frames=1, top=12, warmup=False)
        else:
            search_step()
        torch.cuda.synchronize()
        engine.model.remat = cfg.supernet_remat
        row["search"]["peak_gib_one_step"] = {
            "remat_on": row["search"]["max_memory_allocated_gib"],
            "remat_off": torch.cuda.max_memory_allocated() / 2 ** 30}
        del x, y, xa, ya
    finally:
        lw.close()
        la.close()

    part("search")
    # ---- validation, FPS, the controller, the decoded student
    val = ProcCity(length=2, hw=VAL_HW, seed=seed, split="val")
    val = [val[i] for i in range(2)]
    mious = engine.validate(val, 1, max_items=2)
    check(len(mious) == 5 and all(0.0 <= m <= 1.0 for m in mious),
          f"search: validate {mious}")
    fps = {idx: engine.arch_fps(idx) for idx in (0, 1)}
    check(all(math.isfinite(f) and f > 0 for v in fps.values() for f in v),
          f"search: arch_fps {fps}")
    w0 = engine.controller.weights[1]
    fps0, fps1 = fps[1]
    if fps0 >= cfg.fps_max[1] or fps1 >= cfg.fps_max[1]:
        want_w = w0 / 2
    elif fps0 <= cfg.fps_min[1] or fps1 <= cfg.fps_min[1]:
        want_w = min(w0 * 2, cfg.latency_weight[1] * 2.0 ** 8)
    else:
        want_w = w0
    w = engine.controller.update(1, fps0, fps1)
    check(w == want_w, f"search: controller {w0} -> {w}, want {want_w}")
    metrics = {idx: {"mIoU02": mious[3], "mIoU12": mious[4],
                     "latency02": 1e3 / fps[idx][0],
                     "latency12": 1e3 / fps[idx][1]} for idx in (0, 1)}
    lasts = select_lasts(*(metrics[1][k] for k in
                           ("mIoU02", "latency02", "mIoU12", "latency12")))
    row["validate"] = {"images": f"2x{VAL_HW[0]}x{VAL_HW[1]}",
                       "mious": mious}
    row["arch_fps"] = {str(k): list(v) for k, v in fps.items()}
    row["controller"] = {"band": [cfg.fps_min[1], cfg.fps_max[1]],
                         "weight": [w0, w]}
    part("validate_fps")
    row["decoded_student"] = _decoded_student(
        _searched_plan(engine, lasts), seed, eval_scenes[:2])
    part("decoded_student")

    # ---- resume: save, restore into a new engine, bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        engine.save(tmp, 0, metrics)
        fresh = SearchEngine(cfg, device=DEVICE)
        start = fresh.restore(tmp)
        differ = _same(engine._resume_payload(0), fresh._resume_payload(0))
        check(start == 1, f"search resume: restore returned {start}")
        check(not differ, f"search resume: {len(differ)} entries differ, "
                          f"e.g. {differ[:3]}")
        check(fresh.controller.weights == engine.controller.weights
              and fresh.step == engine.step, "search resume: counters")
        row["resume"] = {"tensors_equal": _tensor_count(
            fresh._resume_payload(0)), "step": fresh.step,
            "controller": fresh.controller.weights}
    del fresh, engine
    torch.cuda.empty_cache()
    part("resume")
    row["card_vs_cpu"] = _search_card_vs_cpu(seed, pool)
    part("card_vs_cpu")
    row["seconds"] = time.perf_counter() - t0
    row["gpu"] = gpu_line()
    emit(row)
    return row


LATENCY_CALIB_BAR = 0.10           # calibrated walk vs measured, each plan
LATENCY_GRAPH_BAR = 0.05           # run_latency's class map vs serve_student
LATENCY_TURNS = 5                  # readings of each, taken in turns
PROFILE_SUM_BAR = 0.10             # stem + body_agg + upsample vs logits


def _sweep_shapes(run):
    """Run `run()` with the conv wrapper, as the serving route calls it,
    recording each distinct 3x3 conv shape (H, W, Ci, Ci2, Co, stride)."""
    from fasterseg_tpu_torch.kernels import conv as kconv
    from fasterseg_tpu_torch.latency import measure
    from fasterseg_tpu_torch.models import fast_body
    shapes = set()
    real = kconv.conv3x3_bn_relu

    def recording(x, w, scale, bias, stride=1, relu=True, x2=None):
        shapes.add((x.shape[1], x.shape[2], x.shape[3],
                    0 if x2 is None else x2.shape[3], scale.shape[0],
                    stride))
        return real(x, w, scale, bias, stride=stride, relu=relu, x2=x2)

    fast_body.conv3x3_bn_relu = measure.conv3x3_bn_relu = recording
    try:
        out = run()
    finally:
        fast_body.conv3x3_bn_relu = measure.conv3x3_bn_relu = real
    return out, sorted(shapes)


def _no_misses(lut_path: str) -> dict:
    """Every key of the supernet tables, both stems and the four shipped
    walks at 1024x2048 is in the table (a provider that raises)."""
    from fasterseg_tpu_torch.cli.calibrate_latency import shipped_plans
    from fasterseg_tpu_torch.core.config import WIDTH_MULT_LIST
    from fasterseg_tpu_torch.latency import (LatencyLUT, build_supernet_tables,
                                             derived_latency_ms,
                                             stem_latency_ms)

    def miss(name):
        raise KeyError(f"latency table {lut_path} misses {name}")

    lut = LatencyLUT(lut_path, provider=miss)
    build_supernet_tables(lut, 16, 12, WIDTH_MULT_LIST, HW)
    stems = {sw: stem_latency_ms(lut, 12, sw, HW) for sw in (1.0, 8.0 / 12)}
    walks = {n: derived_latency_ms(lut, plan, HW)
             for n, plan in shipped_plans().items()}
    return {"entries": len(lut), "misses": 0, "stems_ms": stems,
            "walks_ms": walks}


def _latency_turns(seed: int, first_ms: float, run_latency_ms) -> dict:
    """The latency bar's two readings by one method, taken together:
    `run_latency_ms()` (a call of cli/run_latency, its graph-slope class
    map) and serve_student's runner rebuilt here (the same weights and
    image as `_serve`), its class map by the same `graph_slope_ms` (CUDA
    graphs of 1 and 6 forwards, median of 5 slopes), alternated in
    LATENCY_TURNS turns; `first_ms` is turn 0's run_latency reading. The
    image is cast to bf16 once, before timing, as run_latency's input is:
    both then time the same work (the runner's cast of an fp32 image is
    ~1 % of a class map). The medians, their ratio and each reading's
    spread (max - min over the median)."""
    import torch
    from fasterseg_tpu_torch.latency.measure import graph_slope_ms
    from fasterseg_tpu_torch.models import (DerivedNet, InferenceRunner,
                                            student_plan)
    from fasterseg_tpu_torch.utils import init_random_
    plan = student_plan()
    runner = InferenceRunner(plan, init_random_(DerivedNet(plan), seed),
                             dtype=torch.bfloat16, device=DEVICE)
    x = _seeded_image(seed + 1).to(DEVICE, torch.bfloat16)
    serve = lambda: graph_slope_ms(lambda: runner.classmap(x), n1=1, n2=6,
                                   reps=5, device=DEVICE)[0]
    rl, sv = [first_ms], [serve()]
    for turn in range(1, LATENCY_TURNS):
        if turn % 2:
            sv.append(serve())
            rl.append(run_latency_ms())
        else:
            rl.append(run_latency_ms())
            sv.append(serve())
    spread = lambda v: (max(v) - min(v)) / statistics.median(v)
    return {"run_latency_ms": statistics.median(rl),
            "serve_student_ms": statistics.median(sv),
            "rel": statistics.median(rl) / statistics.median(sv) - 1.0,
            "run_latency_readings": rl, "serve_student_readings": sv,
            "run_latency_spread": spread(rl),
            "serve_student_spread": spread(sv), "method": "graph_slope_ms"}


def phase_latency(seed: int, serve_graph_classmap_ms: float,
                  detail_dir=None) -> dict:
    """Latency measurement through the kernels: the LUT sweep
    (cli/latency_lut) into a temporary table, its coverage with zero
    misses, every distinct 3x3 conv shape it ran against the plain version
    (and timed against cuDNN), run_latency for student and teacher, the
    calibration of the four shipped plans, the auto FPS band, and the
    profile CLI's serving split."""
    import contextlib
    import io
    import numpy as np
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.cli import calibrate_latency, latency_lut
    from fasterseg_tpu_torch.cli import profile as profile_cli
    from fasterseg_tpu_torch.cli import run_latency
    from fasterseg_tpu_torch.latency import (LatencyLUT, derived_latency_ms,
                                             fps_band, h100_lut)
    from fasterseg_tpu_torch.latency.lut import H100_LUT
    from fasterseg_tpu_torch.models import student_plan
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    row = {"phase": "latency", "part_seconds": {},
           "clocks": {"start": clocks_line()}}
    mark = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        row["part_seconds"][name] = now - mark[0]
        row["clocks"][name] = clocks_line()
        mark[0] = now

    def quiet(fn, name):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn()
        if detail_dir:
            with open(os.path.join(detail_dir, f"latency_{name}.log"),
                      "w") as f:
                f.write(buf.getvalue())
        return out

    with tempfile.TemporaryDirectory(prefix="latency_") as tmp:
        lut_path = os.path.join(tmp, "h100_lut.json")
        # the sweep: the counts are 0 just before and read just after
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        ts = time.perf_counter()
        lut, shapes = _sweep_shapes(lambda: quiet(
            lambda: latency_lut.main(["--out", lut_path]), "sweep"))
        torch.cuda.synchronize()
        row["sweep"] = {"seconds": time.perf_counter() - ts,
                        "entries": len(lut),
                        "set": "full (ops, supernet tables, stems, walks)",
                        "launches": kernels.launch_counts(),
                        "conv_shapes": len(shapes)}
        for k in ("conv3x3_bn_relu_s1", "conv3x3_bn_relu_s2"):
            check(row["sweep"]["launches"][k] > 0,
                  f"latency sweep: kernel {k} was not launched")
        row["coverage"] = _no_misses(lut_path)
        row["committed_coverage"] = _no_misses(H100_LUT)
        part("sweep")

        # every distinct 3x3 shape of the sweep against its plain version
        rng = np.random.default_rng(seed)
        cases = [_conv_case(rng, "sweep", h, w, ci, co, s,
                            torch.device(DEVICE), ci2=ci2)
                 for h, w, ci, ci2, co, s in shapes]
        ratios = sorted(((c["ms"] / c["library_ms"], c["shape"])
                         for c in cases), reverse=True)
        row["conv_vs_cudnn"] = {
            "shapes": len(cases),
            "lose_to_cudnn": sum(r > 1.0 for r, _ in ratios),
            "worst_ratios": [{"shape": sh, "kernel_over_cudnn": r}
                             for r, sh in ratios[:10]],
            "max_abs_err_fp32": max(c["max_abs_err_fp32"] for c in cases),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "sum_ms": sum(c["ms"] for c in cases),
            "sum_library_ms": sum(c["library_ms"] for c in cases)}
        if detail_dir:
            with open(os.path.join(detail_dir, "latency_conv_shapes.json"),
                      "w") as f:
                json.dump(cases, f, indent=0)
        del cases
        part("conv_shapes")

        # run_latency: the counts are 0 just before and read just after
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        student = quiet(lambda: run_latency.main(["--lut", lut_path]),
                        "run_latency_student")
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        for k, n in launches.items():
            check(n > 0, f"run_latency: kernel {k} was not launched")
        # serve_student's class map read here by run_latency's own method
        # (graph slope), the two readings alternated in turns
        turns = _latency_turns(seed, student["classmap_ms"], lambda: quiet(
            lambda: run_latency.main(["--lut", lut_path]),
            "run_latency_student")["classmap_ms"])
        teacher = quiet(lambda: run_latency.main(
            ["--teacher", "--lut", lut_path]), "run_latency_teacher")
        rel = turns["rel"]
        check(abs(rel) <= LATENCY_GRAPH_BAR,
              f"run_latency classmap {turns['run_latency_ms']} ms vs the "
              f"serve_student runner's {turns['serve_student_ms']} ms (graph "
              f"slope, medians of {LATENCY_TURNS} turns)")
        for r in (student, teacher):
            check(all(math.isfinite(r[k]) and r[k] > 0 for k in
                      ("logits_ms", "classmap_ms", "logits_call_ms",
                       "classmap_call_ms", "lut_estimate_ms")),
                  "run_latency: readings")
        row["run_latency"] = {
            "student": student, "teacher": teacher,
            "launches_student": launches,
            "classmap_vs_serve_student": turns,
            # a reading: the whole-script serve_student replay, taken minutes
            # earlier by another method
            "classmap_vs_serve_graph_replay":
                turns["run_latency_ms"] / serve_graph_classmap_ms - 1.0}
        part("run_latency")

        calib_path = os.path.join(tmp, "h100_lut_calibration.json")
        calib = quiet(lambda: calibrate_latency.main(
            ["--lut", lut_path, "--apply", "--out", calib_path]), "calibrate")
        fitted = LatencyLUT(lut_path)
        plans = calibrate_latency.shipped_plans()
        errs = {}
        for name, r in calib["plans"].items():
            est = derived_latency_ms(fitted, plans[name], HW)
            errs[name] = est / r["measured_ms"] - 1.0
            check(abs(errs[name]) <= LATENCY_CALIB_BAR,
                  f"calibration: {name} walk {est} ms vs measured "
                  f"{r['measured_ms']} ms")
        row["calibration"] = {**calib, "calibrated_rel_err": errs}
        band = fps_band(fitted, student_plan(), HW)
        committed_band = fps_band(h100_lut(), student_plan(), HW)
        check(0 < band[0] < band[1], f"auto band {band}")
        row["auto_band"] = {"swept_table": list(band),
                            "committed_table": list(committed_band)}
        if detail_dir:
            for src in (lut_path, calib_path):
                shutil.copy(src, os.path.join(
                    detail_dir, "latency_swept_" + os.path.basename(src)))
        part("calibrate")

        prof = quiet(lambda: profile_cli.main([]), "profile")
        total = prof["stem_ms"] + prof["body_agg_ms"] + prof["upsample_ms"]
        check(abs(total / prof["logits_ms"] - 1.0) <= PROFILE_SUM_BAR,
              f"profile: segments {total} ms vs logits {prof['logits_ms']} ms")
        check(prof["gflops"] > 0 and prof["mparams"] > 0, "profile: counts")
        row["profile"] = prof
        part("profile")
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t0
    row["gpu"] = gpu_line()
    emit(row)
    return row


# ------------------------------------------------------ ProcCity study, int8


# At each of these steps the port's val mIoU must lie within MIOU_BAND of
# the JAX package's column (MIOU.md): the band the JAX package held against
# the reference code's torch (its deltas at steps 80-160 reached 0.024),
# with room for the port's own initialisation draw.
MIOU_BAND = 0.04
MIOU_BAND_STEPS = (80, 100, 120, 140, 160)
# the JAX student column from a teacher of the same length (MIOU.md)
MIOU_STUDENT_COLUMN = {8: "student8", 40: "student"}
AGREE_BF16_TRAINED = 99.8          # %, the JAX bar (evidence/fast_body)
BF16_FULL_SCENES = 4               # 1024x2048 val scenes of bf16_trained


def phase_miou(epochs: int, save_dir: str):
    """The ProcCity mIoU study (cli/miou_study.py) on the card: the teacher
    for `epochs` epochs, then the student from it for `epochs` epochs, each
    evaluated after every epoch through the conv kernels (fp32 runner).
    Returns (row, student session, (train, val) scenes); the row's
    `band_misses` are the steps outside the band, which `phase_study`
    holds."""
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.cli import miou_study as ms
    t0 = time.perf_counter()
    train, val = ms.render(ms.N_TRAIN, "train"), ms.render(ms.N_VAL, "val")
    row = {"phase": "miou", "epochs": epochs, "hw": list(ms.HW),
           "batch": ms.BATCH, "scenes": [ms.N_TRAIN, ms.N_VAL],
           "render_s": time.perf_counter() - t0}
    ckpt = {s: os.path.join(save_dir, f"{s}_ckpt")
            for s in ("teacher", "student")}
    columns = {"teacher": "teacher",
               "student": MIOU_STUDENT_COLUMN.get(epochs)}
    session = None
    for stage in ("teacher", "student"):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        # Deterministic algorithms and cuDNN's fixed choice of them (no
        # autotuning), so a run of this script repeats the curve of the last
        # one bit for bit: the band is held against one reproducible run,
        # not a fresh draw of the card's rounding each time. The settings
        # found are put back after the stage.
        before = (torch.backends.cudnn.benchmark,
                  torch.are_deterministic_algorithms_enabled(),
                  torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True)
        try:
            rows, session = ms.run_stage(stage, epochs, train, val,
                                         teacher_ckpt=ckpt["teacher"],
                                         out=ckpt[stage], device=DEVICE,
                                         on_row=emit)
        finally:
            torch.backends.cudnn.benchmark = before[0]
            torch.use_deterministic_algorithms(before[1],
                                               warn_only=before[2])
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        # the steps are autograd over the plain net; every evaluation runs
        # the conv kernels at both strides
        check(launches["conv3x3_bn_relu_s1"] > 0
              and launches["conv3x3_bn_relu_s2"] > 0,
              f"miou {stage}: conv launches {launches}")
        for r in rows:
            check(math.isfinite(r["loss"]) and 0 <= r["val_mIoU"] <= 1,
                  f"miou {stage}: row {r}")
        col = columns[stage]
        table = [{"step": r["step"], "val_mIoU": r["val_mIoU"],
                  "jax": col and ms.jax_val_miou(col, r["step"])}
                 for r in rows]
        cfg = ms.study_config(stage)
        loader = ms.train_loader(cfg, train)
        try:
            loader_ms = _loader_ms(loader)
        finally:
            loader.close()
        steps = epochs * cfg.niters_per_epoch
        row[stage] = {
            "jax_column": col, "rows": table, "launches": launches,
            "final_val_mIoU": rows[-1]["val_mIoU"],
            "ms_per_step": sum(r["train_s"] for r in rows) / steps * 1e3,
            "eval_s_per_epoch": statistics.mean(r["eval_s"] for r in rows),
            "loader_ms_per_batch": loader_ms,
            "seconds": rows[-1]["wall_s"],
            "band_misses": [
                t for t in table if col and t["step"] in MIOU_BAND_STEPS
                and not abs(t["val_mIoU"] - t["jax"]) <= MIOU_BAND]}
        check(epochs < 2 or rows[-1]["val_mIoU"] > rows[0]["val_mIoU"],
              f"miou {stage}: val mIoU did not rise: {table}")
    row["seconds"] = time.perf_counter() - t0
    row["gpu"] = gpu_line()
    emit(row)
    return row, session, (train, val)


def phase_bf16_trained(seed: int, plan, net, val, int8_run) -> dict:
    """The trained student's bf16 kernel class map against the plain fp32
    net (TF32 off) over the study's 40 val scenes at 256x512 (bar, held by
    `phase_study`: the JAX package's 99.8 %), and at 1024x2048 on 4 val
    scenes (a reading); the kernels against their plain versions at the
    study's shapes. The 256x512 maps and launches are those of
    `int8_check.check`'s run (`int8_run`) over the same scenes."""
    import numpy as np
    import torch
    from fasterseg_tpu_torch import kernels
    from fasterseg_tpu_torch.cli import int8_check as ic
    from fasterseg_tpu_torch.cli import miou_study as ms
    from fasterseg_tpu_torch.models import InferenceRunner
    t0 = time.perf_counter()
    res, _, _, maps = int8_run
    runner = lambda dtype, **kw: InferenceRunner(plan, net, dtype=dtype,
                                                 device=DEVICE, **kw)
    k16, p32 = runner(torch.bfloat16), runner(torch.float32,
                                              fast_stem_enabled=False)
    p16 = runner(torch.bfloat16, fast_stem_enabled=False)
    xs = ic.inputs(val, DEVICE)
    row = {"phase": "bf16_trained", "classes": plan.num_classes}
    with ic.no_tf32():
        row["study"] = {
            "images": f"{len(xs)}x{xs[0].shape[1]}x{xs[0].shape[2]}",
            "launches": res["launches"]["bf16"],
            "agree_bf16_kernels_vs_fp32_plain_pct":
                res["bf16_vs_f32_agreement_pct"],
            "agree_bf16_plain_vs_fp32_plain_pct": ic.agreement_pct(
                maps["bf16_plain"], maps["fp32"])}
        xs = ic.inputs(ms.render(BF16_FULL_SCENES, "val", hw=HW), DEVICE)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = ic.classmaps(k16.classmap, xs)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        ref = ic.classmaps(p32.classmap, xs)
        row["full"] = {
            "images": f"{len(xs)}x{xs[0].shape[1]}x{xs[0].shape[2]}",
            "launches": launches,
            "agree_bf16_kernels_vs_fp32_plain_pct": ic.agreement_pct(got,
                                                                     ref),
            "agree_bf16_plain_vs_fp32_plain_pct": ic.agreement_pct(
                ic.classmaps(p16.classmap, xs), ref)}
    for label in ("study", "full"):
        for k, n in row[label]["launches"].items():
            check(n > 0, f"bf16_trained {label}: kernel {k} not launched")
    # the kernels at the study's shapes (8 classes, 256x512), and the
    # upsample at 1024x2048 with 8 classes
    rng = np.random.default_rng(seed)
    h, w = ms.HW
    row["kernel_cases"] = [
        _conv_case(rng, "study stem stage0", h, w, 3, 32, 2, DEVICE,
                   timed=False),
        _conv_case(rng, "study stem stage1 entry", h // 2, w // 2, 32, 64, 2,
                   DEVICE, timed=False),
        _conv_case(rng, "study 1/32 cell", h // 32, w // 32, 64, 64, 1,
                   DEVICE, timed=False)]
    for out_h, out_w in (ms.HW, HW):
        _, _, _, agree = _upsample_agreement(
            rng, DEVICE, out_h // 8, out_w // 8, plan.num_classes, None,
            torch.bfloat16, f"{plan.num_classes} classes at {out_h}x{out_w}")
        row["kernel_cases"].append({
            "case": f"upsample8_argmax {plan.num_classes} classes",
            "out_hw": [out_h, out_w], "agree_random": agree})
    row["seconds"] = time.perf_counter() - t0
    row["gpu"] = gpu_line()
    emit(row)
    return row


def phase_int8(plan, net, int8_run, save_dir: str) -> dict:
    """cli/int8_check.py's check on the trained student (`int8_run`):
    QuantizedRunner (bf16, the kernels) against the bf16 InferenceRunner
    and the plain fp32 net over the 40 val scenes, and against its own
    plain fp32 net, with the JAX acceptance (bars held by `phase_study`);
    every counter rose under it; qvars through a checkpoint and back; int8
    and bf16 class-map time by graph replay at 1024x2048."""
    import torch
    from fasterseg_tpu_torch.cli import int8_check as ic
    from fasterseg_tpu_torch.cli import miou_study as ms
    from fasterseg_tpu_torch.models import InferenceRunner, QuantizedRunner
    from fasterseg_tpu_torch.utils import checkpoint
    t0 = time.perf_counter()
    res, qvars, qrunner, _ = int8_run
    row = {"phase": "int8", **res, "jax_acceptance": ic.acceptance(res)}
    for k, n in res["launches"]["int8"].items():
        check(n > 0, f"int8: kernel {k} not launched by QuantizedRunner")
    path = os.path.join(save_dir, "int8_ckpt")
    checkpoint.save(path, qvars)
    loaded = checkpoint.load(path)
    check(all(loaded["params_q"][k].dtype == torch.int8
              for k in qvars["params_scale"]), "int8: dtype after load")
    row["checkpoint_bytes"] = os.path.getsize(path)
    x = ic.inputs(ms.render(1, "val", hw=HW), DEVICE)[0]
    from_ckpt = QuantizedRunner(plan, loaded, device=DEVICE)
    check(torch.equal(from_ckpt.classmap(x), qrunner.classmap(x)),
          "int8: the checkpoint's runner differs")
    bf16 = InferenceRunner(plan, net, dtype=torch.bfloat16, device=DEVICE)
    # in turns, int8 bf16 bf16 int8: both run the same kernels
    times = {"int8": [], "bf16": []}
    for name in ("int8", "bf16", "bf16", "int8"):
        fn = qrunner.classmap if name == "int8" else bf16.classmap
        times[name].append(graph_ms(lambda: fn(x), reps=1))
    row["graph_classmap_ms_1024x2048"] = {
        **times, "note": "int8 and bf16 run the same kernels on weights of "
                         "the same dtype: a difference is noise"}
    row["seconds"] = time.perf_counter() - t0
    row["gpu"] = gpu_line()
    emit(row)
    return row


def phase_study(seed: int, epochs: int) -> dict:
    """miou, then bf16_trained and int8 on its student (one run of
    `int8_check.check` serves both); the checkpoints in a temporary
    directory. The three phases' bars are held once all three have printed
    their readings, so one run reads every bar; a miss fails the script.
    Returns their rows and the study's (train, val) scenes."""
    from fasterseg_tpu_torch.cli import int8_check as ic
    with tempfile.TemporaryDirectory() as tmp:
        miou, session, scenes = phase_miou(epochs, tmp)
        val = scenes[1]
        plan, net = session.plans[session.student_idx], session.model
        t0 = time.perf_counter()
        run = ic.check(plan, net, val, device=DEVICE)
        check_s = time.perf_counter() - t0
        bf16 = phase_bf16_trained(seed, plan, net, val, run)
        int8 = phase_int8(plan, net, run, tmp)
    missed = [f"miou {stage}: val mIoU {t['val_mIoU']:.4f} at step "
              f"{t['step']}, {abs(t['val_mIoU'] - t['jax']):.4f} from the "
              f"JAX column's {t['jax']:.4f} (band {MIOU_BAND})"
              for stage in ("teacher", "student")
              for t in miou[stage]["band_misses"]]
    got = bf16["study"]["agree_bf16_kernels_vs_fp32_plain_pct"]
    if got < AGREE_BF16_TRAINED:
        missed.append(f"bf16_trained: the bf16 kernel class map agrees with "
                      f"plain fp32 on {got} % < {AGREE_BF16_TRAINED} %")
    # The agreement half of the JAX acceptance measures the quantizer (the
    # JAX package's, bit for bit) on these weights as much as the port: where
    # the JAX package's own arithmetic misses its floor on the same weights,
    # the kernel path is held instead to no more than 0.05 pp below that
    # arithmetic's agreement (`int8_check.agreement_bar`); the floor's miss
    # is then recorded here with both readings.
    recorded = []
    acc, jax_own = ic.acceptance(int8), ic.acceptance(int8["jax_arithmetic"])
    bar = ic.agreement_bar(int8)
    what = (f"int8: int8 vs bf16 class maps agree on "
            f"{int8['classmap_agreement_pct']} %")
    if not bar["met"]:
        missed.append(f"{what} < {bar['floor_pct']} % ({bar['rule']})")
    elif not acc["agreement_met"]:
        recorded.append(
            f"{what} < {acc['agreement_floor_pct']} %; in the JAX package's "
            f"arithmetic {int8['jax_arithmetic']['classmap_agreement_pct']} "
            f"% < {jax_own['agreement_floor_pct']} %, missed there too; held "
            f"instead to >= {bar['floor_pct']} %: met")
    if not acc["delta_met"]:
        missed.append(f"int8: mIoU delta {int8['mIoU_delta_points']} "
                      f"points, not < 0.2")
    got = int8["int8_vs_int8_fp32_plain_pct"]
    if got < 100 * AGREE_FP32:
        missed.append(f"int8: kernel path vs its plain fp32 net {got} % < "
                      f"{100 * AGREE_FP32} %")
    emit({"phase": "study_bars", "check_s": check_s, "missed": missed,
          "missed_by_the_jax_arithmetic_too": recorded})
    check(not missed, "study bars missed: " + "; ".join(missed))
    return {"miou": miou, "bf16_trained": bf16, "int8": int8,
            "scenes": scenes}


SELF_SEARCH_NITERS = 1             # steps of the pretrain and search epochs
SELF_SEARCH_TRAIN_NITERS = 2       # steps of each train stage's epoch
SELF_SEARCH_VAL = 2                # val scenes a validation
R4_ARCH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "evidence", "self_search_r4", "search", "arch_1.npz")


@contextlib.contextmanager
def _recorded_epochs():
    """Inside it, each `SearchEngine.train_epoch` (of the engines the
    stages build) records, before it runs, the engine's conv weights and
    arch tensors, and times its steps (`_step_times`)."""
    import torch
    from fasterseg_tpu_torch.search import SearchEngine
    records = []
    original = SearchEngine.train_epoch

    def train_epoch(self, *args, **kwargs):
        rec = {"convs": {k: v.detach().clone() for k, v in
                         self.model.named_parameters() if v.ndim == 4},
               "arch": [(k, t.detach().clone())
                        for k, t in _arch_tensors(self)]}
        with _step_times(self) as times:
            rec["stats"] = original(self, *args, **kwargs)
        torch.cuda.synchronize()
        rec["readings"] = _search_step_readings(
            times, self.config.data.batch_size)
        records.append(rec)
        return rec["stats"]

    SearchEngine.train_epoch = train_epoch
    try:
        yield records
    finally:
        SearchEngine.train_epoch = original


def _val_mious(save_dir: str) -> dict:
    """The `mIoU/val_*` scalars a search stage wrote."""
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return {r["tag"]: r["value"] for r in rows
            if r["tag"].startswith("mIoU/val_")}


def _config_fields_differ(a, b, prefix: str = "") -> list:
    """Names of the dataclass fields in which two configs differ."""
    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            out += _config_fields_differ(x, y, f"{prefix}{f.name}.")
        elif x != y:
            out.append(f"{prefix}{f.name}")
    return out


def phase_self_search(seed: int, train, val, eval_scenes,
                      search_row=None) -> dict:
    """cli/self_search.py's stages on the card at the chain's configuration
    (16 layers, Fch 12, five widths, ProcCity 256x512, 8 classes, bf16
    search) at reduced lengths, on the miou phase's 160 + 40 scenes: a
    pretrain epoch and a search epoch of SELF_SEARCH_NITERS steps, the
    searched teacher and student and the shipped control arms an epoch of
    SELF_SEARCH_TRAIN_NITERS steps each, validation on SELF_SEARCH_VAL val
    scenes, fps and the report, into a temporary directory. Then the JAX
    chain's own searched student (evidence/self_search_r4) through all
    three kernels at 1024x2048. `search_row`: the search phase's row, whose
    fp32 step ms are printed beside the bf16 ones (a reading: the
    configurations differ in classes and crops)."""
    import torch
    from fasterseg_tpu_torch.cli import miou_study as ms
    from fasterseg_tpu_torch.cli import self_search as ss
    from fasterseg_tpu_torch.latency import fps_band, h100_lut
    t0 = time.perf_counter()
    # the CLI autotunes cuDNN's convs (for runs of thousands of steps); a
    # stage of one step would spend more on the autotuning than it saves
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    row = {"phase": "self_search", "stage_seconds": {}}
    mark = [time.perf_counter()]

    def stage(name):
        now = time.perf_counter()
        row["stage_seconds"][name] = now - mark[0]
        mark[0] = now

    with tempfile.TemporaryDirectory() as out:
        setup = ss.Setup(out=out, device=DEVICE, niters=SELF_SEARCH_NITERS,
                         max_eval_items=SELF_SEARCH_VAL)
        # ---- pretrain: every conv weight moves, no arch tensor does
        with _recorded_epochs() as rec:
            engine = ss.stage_pretrain(setup, 1, train, val)
        check(engine.model.dtype == torch.bfloat16 and all(
            p.dtype == torch.float32 for p in engine.model.parameters()),
            "self_search pretrain: bf16 compute on fp32 parameters")
        losses = rec[0]["stats"]["losses"]
        check(all(math.isfinite(v) for v in losses),
              f"self_search pretrain: losses {losses}")
        after = dict(engine.model.named_parameters())
        still = [k for k, v in rec[0]["convs"].items()
                 if torch.equal(after[k], v)]
        check(not still, f"self_search pretrain: {len(still)} conv weights "
                         f"did not move, e.g. {still[:3]}")
        check(all(torch.equal(a, t) for (_, a), (_, t) in
                  zip(rec[0]["arch"], _arch_tensors(engine))),
              "self_search pretrain: arch parameters moved")
        row["pretrain"] = {"losses": losses, **rec[0]["readings"],
                           "conv_weights_moved": len(rec[0]["convs"]),
                           "val_mIoU": _val_mious(
                               os.path.join(out, "pretrain"))}
        del engine, after, rec
        torch.cuda.empty_cache()
        stage("pretrain")

        # ---- search: the arch tensors move (the teacher's 1-wide ratio
        # logits get no gradient)
        with _recorded_epochs() as rec:
            engine = ss.stage_search(setup, 1, train, val)
        stats = rec[0]["stats"]
        for k in ("loss", "loss_arch", "loss_latency"):
            check(math.isfinite(stats[k]), f"self_search search: {k} "
                                           f"{stats[k]}")
        fixed = {f"arch0.ratio{i}" for i in range(3)}
        wrong = [k for (k, a), (_, t) in zip(rec[0]["arch"],
                                             _arch_tensors(engine))
                 if torch.equal(a, t) != (k in fixed)]
        check(not wrong, f"self_search search: arch tensors moved wrongly: "
                         f"{wrong}")
        mious = {**row["pretrain"]["val_mIoU"],
                 **_val_mious(os.path.join(out, "search"))}
        check(len(mious) == 25 and all(0.0 <= m <= 1.0
                                       for m in mious.values()),
              f"self_search: validate mIoUs {mious}")
        # the band the search ran with, and that it needed no key the
        # committed table lacks
        with open(os.path.join(out, "search", "band.json")) as f:
            band = json.load(f)["fps_band"]
        want = ss.band(h100_lut())
        check(list(want) == band and 0 < band[0] < band[1],
              f"self_search: band {band}, the committed table's {want}")
        row["search"] = {k: stats[k] for k in
                         ("loss", "loss_arch", "loss_latency",
                          "latency_supernet_ms")}
        row["search"].update(rec[0]["readings"])
        row["search"]["val_mIoU"] = _val_mious(os.path.join(out, "search"))
        row["band"] = band
        row["arch_fps"] = {str(i): list(engine.arch_fps(i)) for i in (0, 1)}
        row["lut_keys_measured_on_card"] = sorted(
            set(engine.lut.table) - set(h100_lut().table))
        del engine, rec
        torch.cuda.empty_cache()
        stage("search")

        # ---- train: the searched arms, then the control arms. The control
        # arm could be the miou phase's shipped rows only if this config
        # were the study's; it is not, so it trains here at the same length
        train_setup = dataclasses.replace(setup,
                                          niters=SELF_SEARCH_TRAIN_NITERS)
        row["control_arm"] = {"fields_differing_from_the_study": sorted(
            set(_config_fields_differ(ss.train_config("teacher", "shipped"),
                                      ms.study_config("teacher")))
            | set(_config_fields_differ(
                ss.train_config("student", "shipped"),
                ms.study_config("student"))))}
        row["train"] = {}
        for plan in ("searched", "shipped"):
            for st in ("teacher", "student"):
                ts = time.perf_counter()
                rows = ss.stage_train(train_setup, st, plan, 1, train, val,
                                      on_row=lambda r: None)
                r = rows[-1]
                check(math.isfinite(r["loss"]) and 0 <= r["val_mIoU"] <= 1,
                      f"self_search train {st} {plan}: {r}")
                row["train"][f"{st}_{plan}"] = {
                    "loss": r["loss"], "val_mIoU": r["val_mIoU"],
                    "seconds": time.perf_counter() - ts}
        stage("train")

        # ---- fps of the searched student through the kernels
        fps = ss.stage_fps(setup)
        check(fps["serving_path"] == "kernels"
              and fps["launches"]["conv3x3_bn_relu_s1"] > 0
              and fps["launches"]["conv3x3_bn_relu_s2"] > 0
              and math.isfinite(fps["measured_ms"])
              and fps["measured_ms"] > 0, f"self_search fps: {fps}")
        row["fps"] = fps
        stage("fps")

        # ---- the report: every section (the plots where matplotlib is)
        text = ss.report(setup)
        sections = ["## Search trajectory (student)",
                    "Epochs with the [2,1] student inside the",
                    "## Searched student genotype",
                    "Decoded cells per branch: ",
                    "## Outcome vs shipped genotype",
                    "| teacher val mIoU |", "| student FPS @1024x2048"]
        try:
            import matplotlib  # noqa: F401
            sections.append("![ops](searched_ops1.png)")
        except ImportError:
            sections.append("(genotype plots not rendered: matplotlib")
        missing = [t for t in sections if t not in text]
        check(not missing, f"self_search report lacks {missing}")
        row["report_lines"] = text.count("\n")
        row["report_sections"] = len(sections)
        stage("report")

    # ---- the JAX chain's searched student, which the JAX package could
    # serve only off its Pallas path: here through all three kernels
    plan, lasts = ss.searched_student_plan(R4_ARCH)
    check(lasts == [2, 0], f"self_search r4: lasts {lasts}")
    row["r4_student"] = _decoded_student(plan, seed, eval_scenes[:2],
                                         "self_search r4", bf16=True)
    stage("r4_student")
    torch.backends.cudnn.benchmark = benchmark
    row["step_ms_bf16_vs_search_phase_fp32"] = {
        part: {"bf16": row[part]["step_ms"]["last"],
               "fp32": search_row and search_row[part]["step_ms"]["last"]}
        for part in ("pretrain", "search")}
    row["seconds"] = time.perf_counter() - t0
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
    # cuBLAS needs this before CUDA starts for deterministic products (the
    # resume check of train_student turns deterministic algorithms on)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--agreement-seeds", default=None, metavar="0,1,...",
                    help="only read class-map agreement over these seeds")
    ap.add_argument("--profile-search", action="store_true",
                    help="only build and run the search phase, one search "
                         "step under the profiler")
    ap.add_argument("--latency-only", action="store_true",
                    help="only build, serve the student and run the latency "
                         "phase")
    ap.add_argument("--miou-epochs", type=int, default=8, metavar="N",
                    help="epochs of teacher and of student in the miou "
                         "phase (the JAX columns: 8 or 40)")
    ap.add_argument("--study-only", action="store_true",
                    help="only build and run the miou, bf16_trained and "
                         "int8 phases")
    ap.add_argument("--distributed-only", action="store_true",
                    help="only build, render the scenes and run the "
                         "distributed phase")
    ap.add_argument("--self-search-only", action="store_true",
                    help="only build, render the scenes and run the "
                         "self_search phase")
    ap.add_argument("--detail-dir", default=None, metavar="DIR",
                    help="write the latency phase's long readings (every "
                         "conv shape, the swept table, the CLIs' output) "
                         "here")
    args = ap.parse_args()
    if args.detail_dir:
        os.makedirs(args.detail_dir, exist_ok=True)

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
    if args.profile_search:
        from fasterseg_tpu_torch.data.procgen import ProcCity
        phase_build()
        scenes = ProcCity(length=2, hw=HW, seed=args.seed, split="val")
        phase_search(args.seed, [scenes[i] for i in range(2)], profile=True)
        return 0

    if args.distributed_only:
        from fasterseg_tpu_torch.data.procgen import ProcCity
        phase_build()
        scenes = ProcCity(length=EVAL_IMAGES, hw=HW, seed=args.seed,
                          split="val")
        pool, _ = _train_pool(args.seed)
        phase_distributed(args.seed, pool,
                          [scenes[i] for i in range(EVAL_IMAGES)])
        return 0
    if args.self_search_only:
        from fasterseg_tpu_torch.cli import miou_study as ms
        from fasterseg_tpu_torch.data.procgen import ProcCity
        phase_build()
        t1 = time.perf_counter()
        train, val = ms.render(ms.N_TRAIN, "train"), ms.render(ms.N_VAL,
                                                              "val")
        scenes = ProcCity(length=2, hw=HW, seed=args.seed, split="val")
        emit({"phase": "render", "seconds": time.perf_counter() - t1})
        phase_self_search(args.seed, train, val,
                          [scenes[i] for i in range(2)])
        return 0
    if args.study_only:
        phase_build()
        phase_study(args.seed, args.miou_epochs)
        return 0
    if args.latency_only:
        phase_build()
        student = _serve("student", student_plan, args.seed, timed=True)
        phase_latency(args.seed, student["graph_classmap_ms"],
                      args.detail_dir)
        return 0

    t0 = time.perf_counter()
    build = phase_build()
    kern = phase_kernels(args.seed)
    phase_reference()
    student = _serve("student", student_plan, args.seed, timed=True)
    _serve("teacher", teacher_plan, args.seed, timed=False)
    _, eval_scenes = phase_eval(args.seed)
    pool, render_s = _train_pool(args.seed)
    emit({"phase": "train_pool", "scenes": TRAIN_POOL, "hw": list(HW),
          "render_s": render_s})
    with tempfile.TemporaryDirectory() as tmp:
        phase_train_teacher(args.seed, pool, tmp)
        phase_train_student(args.seed, pool,
                            os.path.join(tmp, "weights0_ckpt"), eval_scenes)
    dist = phase_distributed(args.seed, pool, eval_scenes)
    del pool
    search = phase_search(args.seed, eval_scenes)
    latency = phase_latency(args.seed, student["graph_classmap_ms"],
                            args.detail_dir)
    study = phase_study(args.seed, args.miou_epochs)
    self_search = phase_self_search(args.seed, *study.pop("scenes"),
                                    eval_scenes, search)

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
            "launches_search_decoded_student":
                search["decoded_student"]["launches"][name],
            "launches_latency_sweep": latency["sweep"]["launches"][name],
            "launches_run_latency":
                latency["run_latency"]["launches_student"][name],
            "launches_miou_eval": {
                stage: study["miou"][stage]["launches"][name]
                for stage in ("teacher", "student")},
            "launches_bf16_trained":
                study["bf16_trained"]["study"]["launches"][name],
            "launches_int8": study["int8"]["launches"]["int8"][name],
            "launches_self_search_fps":
                self_search["fps"]["launches"][name],
            "launches_self_search_r4_student":
                self_search["r4_student"]["launches"][name],
            "launches_distributed_eval_per_rank": [
                r[name] for r in dist["gloo_eval"]["launches_per_rank"]],
            "launches_spatial_eval_per_rank": [
                r[name] for r in dist["spatial"]["eval"]["launches_per_rank"]],
            "halo_launches_spatial_eval_per_rank": [
                r.get(name, 0)
                for r in dist["spatial"]["eval"]["halo_launches_per_rank"]],
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
