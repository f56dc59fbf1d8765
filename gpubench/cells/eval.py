"""Repeated whole-image evaluation through `Evaluator.run`.

Traffic parameters: `images` seeded uint8 images of `height` x `width` with
labels (`ignore_share` of the pixels 255), held in host memory; the
protocol's `scales` and `flip`; `dtype` of the forward (the program's
`.logits`, `InferenceRunner.logits` for FasterSeg); `warmup_passes`;
`trace_passes` (the traced sub-window, after the window); `check_from`: one
pass, drawn from the seed among the window's first `check_from`, keeps the
logits its forward returned. Each pass evaluates every image and returns the
hist on the host.

The check: the kept logits against the family reference's fp32 logits of
the same images (the largest difference, in units of the reference logits'
standard deviation); every pass's hist against the hist the protocol's
arithmetic makes of the kept logits (exact: the same images each pass);
and, as a reading, every pass's hist against the reference's.
"""

from __future__ import annotations

import time

import torch

from .. import harness
from ..reference import evaluate as ref_eval


def run(ctx: harness.Ctx) -> harness.Outcome:
    t = ctx.traffic
    dev = ctx.device
    c = ctx.config
    H, W, N = t["height"], t["width"], t["images"]
    if tuple(t["scales"]) != (1.0,) or t["flip"]:
        raise ValueError("the check's reference is single scale, no flip")

    from fasterseg_tpu_torch.eval import Evaluator
    fam = ctx.family
    weights = fam.weights(ctx.plan, ctx.seed, dev)
    runner = fam.program(c, weights, dev, getattr(torch, t["dtype"]))
    images, labels = harness.sample_frames(
        N, H, W, ctx.generator(2), dev, t["ignore_share"], c["num_classes"])
    host = [{"data": images[i].cpu().numpy(), "label": labels[i].cpu().numpy()}
            for i in range(N)]
    keep = {"on": False, "logits": []}

    def forward(x):
        y = runner.logits(x)
        if keep["on"]:
            keep["logits"].append(y.clone())
        return y

    ev = Evaluator(host, c["num_classes"], c["image_mean"], c["image_std"],
                   forward, eval_scales=t["scales"], eval_flip=t["flip"],
                   ignore_label=c["ignore_label"], device=dev)
    for _ in range(t["warmup_passes"]):
        ev.run()
    kept_pass = int(ctx.rng(8).integers(0, t["check_from"]))

    def one_pass(i):
        keep["on"] = i == kept_pass
        return ev.run().hist

    hists = []
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f}s; window of {ctx.seconds}s")
    window_s, passes, pass_s = harness.window(
        ctx, one_pass, lambda i, h: hists.append(h))
    keep["on"] = False
    trace = None
    if ctx.trace:
        from ..trace import profile
        trace = profile(lambda i: ev.run().hist, t["trace_passes"], ctx.sync)
        trace.units = t["trace_passes"] * N
    peak = harness.memory_peak(dev)
    del ev, runner, host
    harness.free(dev)
    ctx.log("window closed, program freed")

    checks, readings = check(ctx, weights, images, labels, keep["logits"],
                             hists)
    elem = torch.tensor([], dtype=getattr(torch, t["dtype"])).element_size()
    costs = fam.costs(ctx.plan, (H, W), elem)
    # `.logits` launches no upsample + argmax
    costs.pop("upsample_bound_s")
    costs.pop("upsamples")
    return harness.Outcome(
        setup_s=setup_s, window_s=window_s, units=passes * N,
        items=passes * N, unit_s=[s / N for s in pass_s for _ in range(N)],
        attempted=passes, failed=0, memory_peak_bytes=peak,
        checks=checks, readings=readings, trace=trace,
        **harness.cost_fields(costs))


def check(ctx, weights, images, labels, kept, hists):
    c = ctx.config
    n, ignore = c["num_classes"], c["ignore_label"]
    if len(kept) != images.shape[0]:
        return {"logit_error": float("inf")}, {"images_kept": len(kept)}
    errors, from_kept, from_ref = [], 0, 0
    for i, logits in enumerate(kept):
        x = ref_eval.normalise(images[i:i + 1], c["image_mean"], c["image_std"])
        ref = ctx.family.reference_logits(ctx.plan, weights, x)
        if ctx.control:
            # the reference in the precision below the stated one, in the
            # program's place
            low = ctx.family.reference_logits(ctx.plan, weights, x,
                                              ctx.check["control"])
            logits = low.permute(0, 2, 3, 1)
        errors.append(ref_eval.logit_error(logits, ref))
        from_kept = from_kept + ref_eval.hist_of_logits(
            logits, labels[i:i + 1], n, ignore)
        prob = torch.exp(torch.log_softmax(ref, 1))
        from_ref = from_ref + ref_eval.hist(torch.argmax(prob, 1),
                                            labels[i:i + 1], n, ignore)
    from_kept, from_ref = from_kept.cpu(), from_ref.cpu()
    if ctx.control:
        hists = [from_kept.numpy()]
    self_d = [ref_eval.hist_distance(from_kept, torch.as_tensor(h))
              for h in hists]
    ref_d = [ref_eval.hist_distance(from_ref, torch.as_tensor(h))
             for h in hists]
    checks = {"logit_error": max(errors),
              "hist_vs_logits": max(self_d) if self_d else float("inf"),
              "hist_distance": max(ref_d) if ref_d else float("inf")}
    return checks, {"passes_checked": len(hists),
                    "labelled_pixels": int(from_ref.sum())}
