"""A closed-loop stream of class-map frames through the program's `.classmap`
(the family's entry point: `InferenceRunner.classmap` for FasterSeg).

Traffic parameters: `height`, `width`, `frames` (distinct seeded frames,
served in turn), `dtype` (the runner's), `capture` ("graph": the call is
captured once as a CUDA graph, and each frame copies its image into the
graph's static input, replays it and synchronises; "eager": each frame calls
`.classmap` from Python and synchronises), `warmup_frames`, `trace_frames`
(the traced sub-window, after the window), and the check's sample:
`check_frames` positions drawn from the seed among the first `check_from`
frames, whose class maps are kept.

The check: the family reference's fp32 logits of each sampled frame's
image; how far the served classes lie below the reference's best logit (the
widest gap, in logits and in units of the frame's logit spread, the mean
gap, the share of pixels whose class is not the reference's).
"""

from __future__ import annotations

import time

import torch

from .. import harness
from ..reference import evaluate as ref_eval


def run(ctx: harness.Ctx) -> harness.Outcome:
    t = ctx.traffic
    dev = ctx.device
    dtype = getattr(torch, t["dtype"])
    H, W, F = t["height"], t["width"], t["frames"]

    fam = ctx.family
    weights = fam.weights(ctx.plan, ctx.seed, dev)
    runner = fam.program(ctx.config, weights, dev, dtype)
    images, _ = harness.sample_frames(F, H, W, ctx.generator(1), dev)
    frames = harness.normalised(images, ctx.config).to(dtype)[:, None]
    del images

    if t["capture"] == "graph" and dev.type == "cuda":
        static = frames[0].clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(3):
                runner.classmap(static)
        torch.cuda.current_stream(dev).wait_stream(side)
        ctx.sync()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = runner.classmap(static)

        def frame(i):
            static.copy_(frames[i % F])
            graph.replay()
            ctx.sync()
            return out
    elif t["capture"] in ("graph", "eager"):
        # "graph" on the CPU (tests): the plain call, nothing captured
        def frame(i):
            y = runner.classmap(frames[i % F])
            ctx.sync()
            return y
    else:
        raise ValueError(f"capture {t['capture']!r}")

    for i in range(t["warmup_frames"]):
        frame(i)
    ctx.sync()

    picks = ctx.rng(7).choice(t["check_from"], size=t["check_frames"],
                              replace=False)
    picks = {int(p) for p in picks}
    kept = {}

    def keep(i, y):
        if i in picks:
            kept[i] = y.clone()

    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f}s; window of {ctx.seconds}s")
    window_s, units, unit_s = harness.window(ctx, frame, keep)
    trace = None
    if ctx.trace:
        from ..trace import profile
        trace = profile(frame, t["trace_frames"], ctx.sync)
    peak = harness.memory_peak(dev)
    del runner, frame
    if t["capture"] == "graph" and dev.type == "cuda":
        del graph, out, static
    harness.free(dev)
    ctx.log("window closed, program freed")

    checks, readings = check(ctx, weights, frames, kept)
    elem = torch.tensor([], dtype=dtype).element_size()
    return harness.Outcome(
        setup_s=setup_s, window_s=window_s, units=units, items=units,
        unit_s=unit_s, attempted=units, failed=0, memory_peak_bytes=peak,
        checks=checks, readings=readings, trace=trace,
        **harness.cost_fields(fam.costs(ctx.plan, (H, W), elem)))


def check(ctx, weights, frames, kept):
    """The sampled class maps against the reference's logits."""
    F = frames.shape[0]
    ref_logits = ctx.family.reference_logits
    gaps = []
    refs = {}
    for i, classmap in sorted(kept.items()):
        j = i % F
        if j not in refs:
            x = frames[j].float().permute(0, 3, 1, 2).contiguous()
            refs[j] = ref_logits(ctx.plan, weights, x)
            if ctx.control:
                # the reference in the precision below the served one, in
                # the program's place
                refs[j] = (refs[j], ref_logits(
                    ctx.plan, weights, x, ctx.check["control"]).argmax(1))
        ref = refs[j][0] if ctx.control else refs[j]
        served = refs[j][1] if ctx.control else classmap
        gaps.append(ref_eval.classmap_gap(ref, served))
    if not gaps:
        return {"widest_gap": float("inf")}, {"frames_checked": 0}
    checks = {"widest_gap": max(g["widest"] for g in gaps),
              "widest_gap_rel": max(g["widest_rel"] for g in gaps),
              "mean_gap": max(g["mean"] for g in gaps),
              "flipped_share": max(g["flipped"] for g in gaps)}
    return checks, {"frames_checked": len(gaps)}
