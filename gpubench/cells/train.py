"""Training steps of `TrainSession` fed by the port's `TrainLoader`: FasterSeg
networks only (another family's configuration is refused by name).

Traffic parameters: `mode` (the session's), `batch_size`, `crop` (h, w),
`scales` (the augmentation's), `samples` seeded uint8 image/label pairs of
`sample_hw` (`ignore_share` of the label pixels 255) held in host memory,
`checked_steps` (the first steps, taken at set-up and compared with the
reference), `trace_steps` (the traced sub-window, after the window). Backend
flags: `cudnn.benchmark = True`, as the port's training CLI sets it, and
TF32 as the configuration's `train.tf32` states (off: PyTorch's cuDNN
default would compute the convs in TF32); the run prints them.

Each step takes the loader's next batch (a span of its own), copies it to
the card, runs `TrainSession.step` and synchronises.

The check, on the checked steps: the loader's batches against the
reference's augmentation of the same samples (uint8 levels, label pixels);
each step's loss; the first gradient, as the optimizer's momentum after one
step gives it (g = buf - weight_decay * w0); the parameters' change after
the checked steps; the two norms compared by the worst leaf, against the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median leaf's
move by round-off alone and are left out of the change.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time

import numpy as np
import torch

from .. import flops, harness
from ..reference import augment as ref_augment
from ..reference import train as ref_train
from ..weights import make as make_weights

FLAT_GRAD = 1e-3   # of the median leaf's reference gradient norm


def _session(ctx, weights, batch, crop, scales):
    from fasterseg_tpu_torch.core.config import (DataConfig,
                                                 cityscapes_teacher_config)
    from fasterseg_tpu_torch.train import TrainSession
    c, t = ctx.config, ctx.traffic
    if t["mode"] != "teacher":
        raise ValueError("the check's reference trains the teacher")
    data = DataConfig(batch_size=batch, image_height=crop[0],
                      image_width=crop[1], train_scale_array=tuple(scales),
                      image_mean=tuple(c["image_mean"]),
                      image_std=tuple(c["image_std"]),
                      ignore_label=c["ignore_label"])
    config = cityscapes_teacher_config(data=data, seed=ctx.seed % 2 ** 31)
    with tempfile.TemporaryDirectory(prefix="gpubench-arch-") as arch_dir:
        np.savez(os.path.join(arch_dir, "arch_0.npz"),
                 **{k: np.asarray(v, np.float32) for k, v in c["arch"].items()},
                 **{k: np.float64(v) for k, v in c["search_metrics"].items()})
        session = TrainSession(config, arch_dir, device=ctx.device)
    plan = session.plans[0]
    harness.check_genotypes(c, dict(zip(plan.lasts, plan.genotypes)))
    session.model.load_state_dict(weights, strict=True)
    return config, session


def _hyper(c, t, config):
    tr = c["train"]
    return {"lr": tr["lr"], "momentum": tr["momentum"],
            "weight_decay": tr["weight_decay"], "aux_weight": tr["aux_weight"],
            "ohem_thresh": tr["ohem_thresh"], "ignore_label": c["ignore_label"],
            "min_kept": config.min_kept(),
            "train_scale_array": list(t["scales"]), "crop_hw": list(t["crop"]),
            "image_mean": c["image_mean"], "image_std": c["image_std"]}


def run(ctx: harness.Ctx) -> harness.Outcome:
    t, c, dev = ctx.traffic, ctx.config, ctx.device
    family = harness.family_name(c)
    if family != "fasterseg":
        raise SystemExit(f"gpubench: the train kind trains FasterSeg "
                         f"networks only; {c['name']!r} is of the family "
                         f"{family!r}")
    batch, crop = t["batch_size"], tuple(t["crop"])
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
        # the configuration's precision: fp32 convs (cuDNN's default is TF32)
        torch.backends.cudnn.allow_tf32 = c["train"]["tf32"]
        torch.backends.cuda.matmul.allow_tf32 = c["train"]["tf32"]
    ctx.log("backend flags: cudnn.benchmark=%s cudnn.allow_tf32=%s "
            "matmul.allow_tf32=%s deterministic=%s" % (
                torch.backends.cudnn.benchmark,
                torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
                torch.are_deterministic_algorithms_enabled()))
    weights = make_weights(ctx.plan, ctx.seed, dev)
    config, session = _session(ctx, weights, batch, crop, t["scales"])
    hp = _hyper(c, t, config)
    ctx.log("session built")

    from fasterseg_tpu_torch.data import InMemoryDataset, get_train_loader
    images, labels = harness.sample_frames(
        t["samples"], *t["sample_hw"], ctx.generator(3), dev,
        t["ignore_share"], c["num_classes"])
    samples = [{"data": images[i].cpu().numpy(),
                "label": labels[i].cpu().numpy(), "fn": f"s{i}"}
               for i in range(t["samples"])]
    loader = get_train_loader(config, InMemoryDataset.bind(samples))
    it = iter(loader)
    ctx.log("samples made, loader started")
    wait = []

    def step(i):
        a = time.perf_counter()
        x, y = next(it)
        wait.append(time.perf_counter() - a)
        m = session.step(torch.from_numpy(x).to(dev),
                         torch.from_numpy(y).to(dev))
        ctx.sync()
        return x, y, m

    params = [p for g in session.state.optimizer.param_groups
              for p in g["params"]]
    names = {id(p): n for n, p in session.model.named_parameters()}
    try:
        checked, losses, buf1 = [], [], None
        for k in range(t["checked_steps"]):
            x, y, m = step(k)
            checked.append((x, y))
            losses.append(float(m["loss"]))
            ctx.log(f"checked step {k + 1}: loss {losses[-1]!r}")
            if k == 0:
                st = session.state.optimizer.state
                buf1 = {names[id(p)]: st[p]["momentum_buffer"].clone()
                        for p in params if p in st}
        after = {names[id(p)]: p.detach().clone() for p in params}
        wait.clear()
        setup_s = time.perf_counter() - ctx.t_start
        ctx.log(f"set-up {setup_s:.3f}s; window of {ctx.seconds}s")
        window_s, steps, step_s = harness.window(ctx, step)
        spans = {"loader_wait": list(wait)}
        trace = None
        if ctx.trace:
            from ..trace import profile
            trace = profile(step, t["trace_steps"], ctx.sync)
        peak = harness.memory_peak(dev)
    finally:
        loader.close()
    del session, it, step, params
    harness.free(dev)

    ctx.log("window closed, program freed")
    checks, readings = check(ctx, weights, hp, images, labels, checked,
                             losses, buf1, after, loader)
    ctx.log("checked")
    hw = crop
    return harness.Outcome(
        setup_s=setup_s, window_s=window_s, units=steps, items=steps * batch,
        unit_s=step_s, attempted=steps, failed=0, memory_peak_bytes=peak,
        checks=checks, readings=readings, spans=spans, trace=trace,
        flops_per_unit=3 * batch * flops.plan_flops(ctx.plan, hw))


def _gaps(prog, ref, keep):
    """Each leaf's gap of norms, against the reference's norm of the leaf or
    of the median leaf, whichever is larger (a leaf the program lacks
    counts as zero)."""
    names = [n for n in ref if n in keep]
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))
    rn = {n: norm(ref[n]) for n in names}
    pn = {n: norm(prog[n]) if n in prog else 0.0 for n in names}
    med = statistics.median(rn.values())
    return {n: abs(pn[n] - rn[n]) / max(rn[n], med) for n in names}


def check(ctx, weights, hp, images, labels, checked, losses, buf1, after,
          loader):
    dev = ctx.device
    # the loader's batches against the reference's augmentation
    spe = len(loader)
    levels, label_px = 0.0, 0
    level = ref_augment.level(hp["image_std"])
    for k, (x, y) in enumerate(checked):
        rx, ry = ref_augment.batch(images, labels, loader.seed, k // spe,
                                   k % spe, loader.batch_size, hp)
        levels = max(levels, float((torch.from_numpy(x).to(dev) - rx).abs()
                                   .max()) / level)
        label_px += int((torch.from_numpy(y).to(dev).long() != ry).sum())
    ctx.log("loader's batches checked")
    batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
               for x, y in checked]
    precision = ctx.check["control"] if ctx.control else "fp32"
    ref = ref_train.run_steps(ctx.plan, weights, batches, hp)
    if ctx.control:
        # the reference in the precision below the stated one, in the
        # program's place
        low = ref_train.run_steps(ctx.plan, weights, batches, hp, precision)
        losses, after = low["losses"], low["params"]
        grads1 = low["first_grads"]
    else:
        grads1 = {n: b - hp["weight_decay"] * weights[n]
                  for n, b in buf1.items()}
    rg = ref["first_grads"]
    med = statistics.median(float(torch.linalg.vector_norm(g.double()))
                            for g in rg.values())
    moving = {n for n, g in rg.items()
              if float(torch.linalg.vector_norm(g.double())) >= FLAT_GRAD * med}
    grad = _gaps(grads1, rg, set(rg))
    d_prog = {n: after[n] - weights[n] for n in ref["params"]}
    d_ref = {n: ref["params"][n] - weights[n] for n in ref["params"]}
    change = _gaps(d_prog, d_ref, moving)
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    med = statistics.median
    checks = {"first_loss_gap": loss[0], "loss_gap": max(loss),
              "grad_gap": max(grad.values()),
              "grad_gap_median": med(grad.values()),
              "change_gap": max(change.values()),
              "change_gap_median": med(change.values()),
              "augment_levels": levels, "augment_label_px": float(label_px)}
    readings = {"losses": losses, "ref_losses": ref["losses"],
                "grad_leaf": max(grad, key=grad.get),
                "change_leaf": max(change, key=change.get),
                "leaves_flat": len(rg) - len(moving)}
    return checks, readings
