"""Dry run of data parallelism: one distill step and one bi-level search step
of the production step functions on N ranks, each held against the one-rank
step on the global batch.

Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`, with its
tiny models: a search engine of 5 layers, Fch 8, two widths and one arch at
64x64 (labels at 1/8), and a teacher and student decoded from that engine's
own arch parameters, trained at 64x128 (`train_step` with the frozen teacher:
OHEM + KL, SGD). The global batch is two images a rank, with another share
of ignored pixels in each image, so the ranks' valid and kept counts differ.

    python -m fasterseg_tpu_torch.parallel.dryrun N [--device cuda|cpu]

`--device cuda` (the default) runs N NCCL ranks on cuda:0..N-1 (more ranks
than cards raise), `cpu` N gloo ranks on the CPU. Each rank makes
the step on its shard under the mesh; then, from the same initial state, the
same step without a mesh on the whole global batch, all in float64 (the
tiny nets' BN over few values makes fp32 rounding move deep gradients by
percents). Every parameter, BN statistic and momentum buffer, every arch
tensor and the losses must lie within atol 1e-10 + rtol 1e-8 of the one-rank
step's (`loss_latency` within rtol 1e-12), and equal rank 0's bit for bit.
Prints one line a step; a missed bar raises, and the command exits 1.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .mesh import Mesh, launch, rank_devices, shard_batch

ATOL, RTOL = 1e-10, 1e-8
LATENCY_RTOL = 1e-12
PER_RANK = 2
SEARCH_HW = (64, 64)
DISTILL_HW = (64, 128)


def tiny_search_config(batch: int):
    """`dryrun_multichip`'s tiny engine configuration at a global batch."""
    from ..core.config import DataConfig, EvalConfig, SearchConfig
    h, w = SEARCH_HW
    return SearchConfig(
        data=DataConfig(synthetic=True, image_height=h, image_width=w,
                        batch_size=batch, gt_down_sampling=8),
        eval=EvalConfig(eval_height=h, eval_width=w), layers=5, Fch=8,
        pretrain=False, width_mult_list=(8.0 / 12, 1.0),
        prun_modes=("arch_ratio",), stem_head_width=((8.0 / 12, 8.0 / 12),),
        latency_weight=(1e-2,), fps_min=(155.0,), fps_max=(175.0,))


def tiny_engine(config, device, mesh: Optional[Mesh] = None,
                dtype: torch.dtype = torch.float64, lut=None):
    """A SearchEngine of `config` (a tiny one: `tiny_search_config`) with
    its supernet, arch tensors and latency tables converted to `dtype`.
    `lut` defaults to the H100 cost model's (the JAX dry run's engine is
    priced by its TPU model)."""
    from ..latency import LatencyLUT
    from ..latency.cost_model import H100CostModel
    from ..search import SearchEngine
    if lut is None:
        lut = LatencyLUT(provider=H100CostModel().provider)
    engine = SearchEngine(config, device=device, lut=lut, mesh=mesh)
    engine.model.to(dtype)
    for t in engine._arch_tensors():
        t.data = t.data.to(dtype)
    engine.tables = {k: v.to(dtype) for k, v in engine.tables.items()}
    return engine


def global_batch(seed: int, batch: int, hw: Tuple[int, int],
                 label_hw: Tuple[int, int]):
    """Images N(0, 1) and labels in [0, 19) with image i's share of ignored
    pixels 0.05 + 0.5 i / batch (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, *hw, 3))
    y = rng.integers(0, 19, (batch, *label_hw)).astype(np.int64)
    for i in range(batch):
        y[i][rng.random(label_hw) < 0.05 + 0.5 * i / batch] = 255
    return torch.from_numpy(x), torch.from_numpy(y)


def distill_plans(arch=None):
    """(student plan, teacher plan) decoded from `arch` (ArchParams;
    default: a fresh tiny engine's arch 0, every logit 1e-3), the teacher
    ignoring skips as training does."""
    from ..core import build_plan, decode_network
    from ..models.supernet import ArchParamSet
    c = tiny_search_config(PER_RANK)
    if arch is None:
        from ..core.genotype import ArchParams
        ap = ArchParamSet.create(c.layers, num_widths=len(c.width_mult_list))
        f64 = lambda t: t.detach().double().numpy()
        arch = ArchParams(alphas=[f64(a) for a in ap.alphas],
                          betas=[None, f64(ap.betas[1]), f64(ap.betas[2])],
                          ratios=[f64(r) for r in ap.ratios])
    return tuple(
        build_plan(decode_network(arch, c.width_mult_list, c.layers,
                                  ignore_skip=ignore_skip),
                   [2, 1], Fch=c.Fch, num_classes=19,
                   stem_head_width=c.stem_head_width[0])
        for ignore_skip in (False, True))


def distill_nets(engine, dtype: torch.dtype = torch.float64):
    """(student, teacher) of `distill_plans` from the engine's arch 0, on its
    device, built with the JAX package's init draw for seeds 0 and 1."""
    from ..models import DerivedNet
    from ..utils.weights import init_jax_draw_
    nets = [init_jax_draw_(DerivedNet(plan), seed).to(
        dtype=dtype, device=engine.device)
        for seed, plan in enumerate(distill_plans(engine.numpy_arch(0)))]
    return nets[0], nets[1].eval().requires_grad_(False)


def distill_step(engine, x: torch.Tensor, y: torch.Tensor,
                 mesh: Optional[Mesh] = None) -> Dict:
    """One student step (OHEM on three heads + KL against the frozen
    teacher, SGD) from the fresh nets, on this rank's shard of (x, y) under
    `mesh` or on all of it. Returns the state after it and the metrics, on
    the CPU."""
    from ..parallel.mesh import replicate
    from ..train import TrainState, make_optimizer, train_step
    student, teacher = distill_nets(engine, x.dtype)
    replicate(student, mesh)
    state = TrainState(student, make_optimizer(student.parameters(),
                                               steps_per_epoch=10))
    xs, ys = (t.to(engine.device) for t in shard_batch((x, y), mesh))
    m = train_step(state, xs, ys, teacher, min_kept=len(x) * x.shape[1]
                   * x.shape[2] // 16, mesh=mesh)
    momentum = {f"momentum.{name}": state.optimizer.state[p][
        "momentum_buffer"] for name, p in student.named_parameters()
        if p in state.optimizer.state}
    return {"state": _cpu({**student.state_dict(), **momentum}),
            "metrics": _cpu(m)}


def search_step(engine, x: torch.Tensor, y: torch.Tensor,
                mesh: Optional[Mesh] = None) -> Dict:
    """One arch step then one weight step of `engine` (made with `mesh`
    or without) on this rank's shard of (x, y) or on all of it, with the
    draws of update 0. Returns the state after them and the metrics, on the
    CPU."""
    from ..search.loop import _step_generator
    xs, ys = (t.to(engine.device) for t in shard_batch((x, y), mesh))
    gen = _step_generator(engine.config.seed + 1, 0)
    am = engine.arch_step(xs, ys, gen)
    loss = engine.weight_step(xs, ys, False, gen)
    arch = {f"arch{i}.{j}": t for i, ap in engine.arch_params.items()
            for j, t in enumerate(ap.tensors())}
    momentum = {f"momentum.{name}": engine.optimizer.state[p][
        "momentum_buffer"] for name, p in engine.model.named_parameters()}
    return {"state": _cpu({**engine.model.state_dict(), **arch, **momentum}),
            "metrics": _cpu({**am, "loss": loss})}


def _cpu(tree: Dict) -> Dict:
    return {k: v.detach().cpu() for k, v in tree.items()}


def compare(got: Dict, want: Dict, exact_keys=()) -> Dict:
    """The largest |got - want| over every tensor of two step results, and
    the keys over atol + rtol |want| (`LATENCY_RTOL` alone for
    `exact_keys` of the metrics)."""
    worst, worst_key, over = 0.0, "", []
    for part in ("state", "metrics"):
        if set(got[part]) != set(want[part]):
            raise KeyError(f"{part}: {set(got[part]) ^ set(want[part])}")
        for k, w in want[part].items():
            g = got[part][k]
            if not w.is_floating_point():
                if not torch.equal(g, w):
                    over.append(k)
                continue
            err = (g.double() - w.double()).abs()
            e = float(err.max()) if err.numel() else 0.0
            if e > worst:
                worst, worst_key = e, k
            bar = (LATENCY_RTOL * w.double().abs() if k in exact_keys
                   else ATOL + RTOL * w.double().abs())
            if bool((err > bar).any()):
                over.append(k)
    return {"max_abs_err": worst, "worst": worst_key, "over": over}


def _same_on_every_rank(mesh: Mesh, result: Dict) -> bool:
    """Whether this rank's step result equals rank 0's bit for bit."""
    flat = torch.cat([v.double().reshape(-1) for part in ("state", "metrics")
                      for _, v in sorted(result[part].items())])
    ref = flat.to(mesh.device)
    mesh.broadcast_([ref])
    return torch.equal(flat, ref.cpu())


def run_steps(mesh: Mesh, seed: int = 0) -> Dict:
    """On every rank: both steps under `mesh`, both again without a mesh on
    the global batch, the comparisons; raises on a missed bar."""
    batch = PER_RANK * mesh.world
    out = {}
    engine = tiny_engine(tiny_search_config(batch), mesh.device, mesh)
    cases = {"distill": (distill_step, global_batch(
                 seed, batch, DISTILL_HW, DISTILL_HW)),
             "search": (search_step, global_batch(
                 seed + 1, batch, SEARCH_HW,
                 (SEARCH_HW[0] // 8, SEARCH_HW[1] // 8)))}
    for name, (step, (bx, by)) in cases.items():
        bytes_before = mesh.bytes_reduced
        got = step(engine, bx, by, mesh)
        reduced = mesh.bytes_reduced - bytes_before
        want = step(tiny_engine(tiny_search_config(batch), mesh.device),
                    bx, by)
        cmp = compare(got, want, exact_keys=("loss_latency",))
        same = _same_on_every_rank(mesh, got)
        out[name] = {"loss": float(got["metrics"]["loss"]),
                     "bytes_all_reduced": reduced, "same_on_ranks": same,
                     **cmp}
        if cmp["over"] or not same:
            raise AssertionError(
                f"dryrun rank {mesh.rank} {name} step: over the bar at "
                f"{cmp['over'][:5]}, worst {cmp['max_abs_err']:.3g} at "
                f"{cmp['worst']}, equal to rank 0: {same}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL, a card a rank; the default) or cpu "
                        "(gloo)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    backend, devices = rank_devices(args.n, args.device)
    results = launch(run_steps, args.n, backend, devices, args=(args.seed,))
    for name in ("distill", "search"):
        r = results[0][name]
        print(f"dryrun({args.n}, {args.device}): {name} step "
              f"loss={r['loss']:.6f} max|d| vs one rank={r['max_abs_err']:.3g}"
              f" all-reduced {r['bytes_all_reduced']} B a rank OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
