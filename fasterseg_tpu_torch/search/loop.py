"""Search engine: supernet pretrain and bi-level architecture search.

Counterpart of the JAX package's search/loop.py (the reference's
search/train_search.py). A search step (train_search.py:223-253) is an arch
step on a batch of the held-out half, then a weight step (SGD, momentum
0.9, weight decay 5e-4, global-norm clip 5) on the supernet's multi-forward
loss (model_search.py:478-505):

  search    one forward per arch at its own width mode, then max and min
            width on the last arch
  pretrain  max, min and two random widths on arch 0 (the sandwich rule),
            no arch step

Each forward's loss is the OHEM loss summed over the five heads; the BN
running statistics move through the forwards in that order, and through
the arch step's forwards into the weight step's.

Per epoch: validation of all five heads, the decoded architectures' FPS
from the latency LUT (arch_logging, train_search.py:274-303),
checkpoints, and the FPS-band latency-weight controller.

Reference quirks kept, as in the JAX package: the pretrain sandwich runs on
arch 0 (the reference never moves arch_idx in pretrain), and the search
sandwich on the last arch. Random draws come from a torch.Generator seeded
by (seed + 1, update index), made on the host and copied to the device, so
a step is a pure function of its position and both devices draw alike.

Runs on CUDA unless the caller passes device="cpu". With `mesh` (a
`parallel.Mesh`, one engine a rank) search is data-parallel as the JAX
package's SPMD steps are: weights and arch parameters replicated from rank 0,
each rank stepping on its shard of the global batch with the sync BN rows and
global losses, both steps' gradients sum-reduced in one flat bucket (the
weight step's clip after the reduction; the latency term, a function of the
replicated arch parameters alone, added on rank 0 only, so its gradient
counts once), the same host draws on every rank, validation sharded over the
items with its counts reduced, and checkpoints written by rank 0.

`SearchConfig.compute_dtype="bfloat16"` runs the supernet in bf16 as the JAX
package does (`Supernet(dtype=)`): parameters, both optimizers' states, BN
statistics and the arch parameters stay fp32, and so do the losses and the
latency terms. `run_search(plot_genotypes=True)` renders each arch's decoded
genotypes after every search epoch (utils/plotting.py, matplotlib) through
the metric writer.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.config import SearchConfig
from ..core.genotype import ArchParams, decode_network
from ..core.plan import build_plan, objective_acc_lat
from ..data import Cityscapes, SyntheticDataset, get_train_loader
from ..data.preprocess import eval_preprocess
from ..eval.metrics import compute_score, confusion_hist
from ..latency import (LatencyLUT, build_supernet_tables, derived_latency_ms,
                       reference_lut, stem_latency_ms)
from ..models.infer import resolve_device
from ..models.supernet import ArchParamSet, Supernet, init_supernet
from ..parallel.mesh import replicate, sync_batchnorm_
from ..train.loop import (clip_by_global_norm_, make_optimizer,
                          set_learning_rate)
from ..train.loss import ohem_cross_entropy
from ..utils.checkpoint import load, partial_load, save, save_arch
from .architect import (LatencyWeightController, latency_terms,
                        make_arch_optimizer)
from .gumbel import draw_noise, sample_ratios

logger = logging.getLogger("fasterseg_tpu_torch.search")

VALID_NAMES = ("8s", "16s", "32s", "8s_32s", "16s_32s")
# SearchConfig.compute_dtype -> the supernet's compute dtype (None: fp32, as
# the input comes)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def forward_plan(n_arch: int, prun_modes: Sequence[str], num_widths: int,
                 pretrain: bool) -> List[Tuple[int, str]]:
    """(arch_idx, width mode) of each forward of a step, in the reference's
    order (model_search.py:478-505; the JAX package's loop.py:181-197)."""
    forwards = []
    if not pretrain:
        forwards += [(idx, prun_modes[idx]) for idx in range(n_arch)]
    if num_widths > 1:
        sandwich = 0 if pretrain else n_arch - 1
        modes = ["max", "min"] + (["random", "random"] if pretrain else [])
        forwards += [(sandwich, mode) for mode in modes]
    elif pretrain:
        forwards.append((0, "max"))
    return forwards


def _step_generator(seed: int, index: int) -> torch.Generator:
    """The host generator of update `index`, a pure function of both."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & (2 ** 63 - 1))


def to_device(tree, device: torch.device):
    """Host tensors (nested in lists and dicts) on `device`, through pinned
    memory without a host wait where the device is a card."""
    if isinstance(tree, torch.Tensor):
        if device.type == "cuda":
            return tree.pin_memory().to(device, non_blocking=True)
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


class SearchEngine:
    """The supernet, both archs' parameters, both optimizers, the latency
    tables and the controller, on `device` (CUDA by default; tests pass
    "cpu"), or with `mesh` on the mesh's device as one rank of a
    data-parallel search."""

    def __init__(self, config: SearchConfig, lut: Optional[LatencyLUT] = None,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        self.config = c = config
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.wml = tuple(c.width_mult_list)
        self.nw = len(self.wml)
        self.prun_modes = tuple(c.prun_modes)
        self.num_widths_per_arch = [
            self.nw if m == "arch_ratio" else 1 for m in self.prun_modes]
        pretrain = bool(c.pretrain)

        self.model = init_supernet(Supernet(
            layers=c.layers, num_classes=c.num_classes, Fch=c.Fch,
            width_mult_list=self.wml, stem_head_width=c.stem_head_width,
            remat=c.supernet_remat, dtype=COMPUTE_DTYPES[c.compute_dtype]),
            c.seed).to(self.device)
        replicate(sync_batchnorm_(self.model, mesh), mesh)
        self.arch_params: Dict[int, ArchParamSet] = {
            i: ArchParamSet.create(c.layers, num_widths=nwi,
                                   device=self.device)
            for i, nwi in enumerate(self.num_widths_per_arch)}
        if mesh is not None:
            mesh.broadcast_(self._arch_tensors())

        # weight optimizer (train_search.py:83-101): optax's
        # chain(add_decayed_weights, sgd(exponential_decay(staircase)))
        self.optimizer = make_optimizer(
            self.model.parameters(), 2e-2 if pretrain else c.lr, c.momentum,
            c.weight_decay, c.lr_decay, c.niters_per_epoch(pretrain))
        self.step = 0
        # arch optimizer (architect.py:22-24), one Adam over both archs
        self.arch_optimizer = make_arch_optimizer(
            self._arch_tensors(), c.arch_learning_rate)

        # latency tables (the architect's latency input, architect.py:66)
        self.lut = lut if lut is not None else reference_lut()
        tables = build_supernet_tables(self.lut, c.layers, c.Fch, self.wml,
                                       c.latency_input_hw)
        self.tables = {k: torch.from_numpy(v).to(self.device)
                       for k, v in tables.items()}
        self.stem_ms = [stem_latency_ms(self.lut, c.Fch, shw[0],
                                        c.latency_input_hw)
                        for shw in c.stem_head_width]
        self.controller = LatencyWeightController(
            c.latency_weight, c.fps_min, c.fps_max)
        self.min_kept = c.min_kept(pretrain)
        self.metrics_log: List[dict] = []

    def _arch_tensors(self) -> List[torch.Tensor]:
        return [t for idx in sorted(self.arch_params)
                for t in self.arch_params[idx].tensors()]

    # ---------------- losses and steps ----------------

    def forwards(self, pretrain: bool) -> List[Tuple[int, str]]:
        return forward_plan(len(self.arch_params), self.prun_modes, self.nw,
                            pretrain)

    def draw_noise(self, forwards, generator: Optional[torch.Generator]):
        """The host draws of each forward's width sample."""
        return [draw_noise(self.arch_params[idx].ratios, mode, self.nw,
                           generator) for idx, mode in forwards]

    def supernet_loss(self, x: torch.Tensor, y: torch.Tensor,
                      arch_params: Dict[int, ArchParamSet], forwards,
                      noise) -> torch.Tensor:
        """The multi-forward loss (model_search.py:478-505): the sum over
        `forwards` of each forward's OHEM loss summed over the five heads.
        `noise` holds each forward's draws (on x's device)."""
        crit = functools.partial(ohem_cross_entropy, ignore_label=255,
                                 thresh=0.7, min_kept=self.min_kept,
                                 mesh=self.mesh)
        total = None
        for (idx, mode), draws in zip(forwards, noise):
            ap = arch_params[idx]
            ratios = sample_ratios(ap.ratios, mode, self.nw, noise=draws)
            preds = self.model(x, idx, ap.alphas, ap.betas, ratios)
            loss = sum(crit(p, y) for p in preds)
            total = loss if total is None else total + loss
        return total

    def _reduced_grads(self, tensors: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Every tensor's gradient, zeros where it has none (optax updates
        every leaf; torch's optimizers skip a tensor whose grad is None:
        weight decay, momentum and Adam's step count too), summed over the
        mesh's ranks."""
        for t in tensors:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        grads = [t.grad for t in tensors]
        if self.mesh is not None:
            self.mesh.reduce_grads_(grads)
        return grads

    def _reduced(self, loss: torch.Tensor) -> torch.Tensor:
        """A rank's share of a global loss, summed over the ranks."""
        loss = loss.detach()
        return loss if self.mesh is None else self.mesh.all_reduce_(
            loss.clone())

    def weight_step(self, x: torch.Tensor, y: torch.Tensor, pretrain: bool,
                    generator: Optional[torch.Generator] = None,
                    noise=None) -> torch.Tensor:
        """One update of the supernet's weights (loop.py:212-238): the
        multi-forward loss with the arch parameters held fixed, the global
        norm clip, then SGD with decayed weights at the staircase rate.
        Returns the loss (a device tensor; of the global batch)."""
        self.model.train()
        sync_batchnorm_(self.model, self.mesh)
        forwards = self.forwards(pretrain)
        if noise is None:
            noise = to_device(self.draw_noise(forwards, generator),
                              self.device)
        fixed = {i: ap.detached() for i, ap in self.arch_params.items()}
        opt = self.optimizer
        opt.zero_grad(set_to_none=True)
        loss = self.supernet_loss(x, y, fixed, forwards, noise)
        loss.backward()
        params = [p for g in opt.param_groups for p in g["params"]]
        clip_by_global_norm_(self._reduced_grads(params),
                             self.config.grad_clip)
        set_learning_rate(opt, self.step)
        opt.step()
        self.step += 1
        return self._reduced(loss)

    def arch_step(self, x: torch.Tensor, y: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise=None, latency_noise=None) -> Dict[str, torch.Tensor]:
        """One Adam update of every arch parameter (loop.py:240-279) on the
        task loss plus sum_i lat_w[i] * latency_i. Returns loss_arch,
        loss_latency and latency_supernet_ms (device tensors; loss_arch of
        the global batch)."""
        self.model.train()
        sync_batchnorm_(self.model, self.mesh)
        forwards = self.forwards(False)
        if noise is None:
            noise = self.draw_noise(forwards, generator)
            latency_noise = {
                idx: draw_noise(ap.ratios, self.prun_modes[idx], self.nw,
                                generator)
                for idx, ap in self.arch_params.items()}
            noise, latency_noise = to_device((noise, latency_noise),
                                             self.device)
        tensors = self._arch_tensors()
        self.arch_optimizer.zero_grad(set_to_none=True)
        loss = self.supernet_loss(x, y, self.arch_params, forwards, noise)
        pins = [self.model.width_pins(i) for i in range(len(self.arch_params))]
        lats = latency_terms(self.tables, self.stem_ms, self.arch_params,
                             self.config.layers, self.nw, self.prun_modes,
                             [p[0] for p in pins], [p[1] for p in pins],
                             noise=latency_noise)
        lat_w = self.controller.weights
        loss_lat = sum(lat_w[i] * l for i, l in lats.items())
        # the latency term depends on the replicated arch parameters only:
        # one rank adds it, so the reduced gradient counts it once
        total = loss if self.mesh is not None and self.mesh.rank else (
            loss + loss_lat)
        total.backward(inputs=tensors)
        self._reduced_grads(tensors)
        self.arch_optimizer.step()
        return {"loss_arch": self._reduced(loss),
                "loss_latency": loss_lat.detach(),
                "latency_supernet_ms": lats[len(lats) - 1].detach()}

    # ---------------- epoch orchestration ----------------

    def _batch(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        x, y = batch
        return to_device((torch.from_numpy(x), torch.from_numpy(y)),
                         self.device)

    def train_epoch(self, loader_model, loader_arch, epoch: int,
                    pretrain: bool, update_arch: bool,
                    niters: Optional[int] = None) -> Dict:
        """`niters` steps (loop.py:281-321). Both loaders seek to the epoch,
        so its batches are a pure function of its number; the losses stay
        on the device until the epoch ends."""
        niters = niters or self.config.niters_per_epoch(pretrain)
        loader_model.seek(epoch)
        if update_arch:
            loader_arch.seek(epoch)
        it_model = iter(loader_model)
        it_arch = iter(loader_arch) if update_arch else None
        losses, arch = [], []
        for step in range(niters):
            gen = _step_generator(self.config.seed + 1, epoch * niters + step)
            if update_arch:
                arch.append(self.arch_step(*self._batch(next(it_arch)), gen))
            losses.append(self.weight_step(*self._batch(next(it_model)),
                                           pretrain, gen))
        losses = torch.stack(losses).tolist()
        last = {"loss": losses[-1], "losses": losses}
        if arch:
            last.update({k: float(v) for k, v in arch[-1].items()})
        self.metrics_log.append({"epoch": epoch, **last})
        return last

    # ---------------- validation / decode / fps ----------------

    @torch.no_grad()
    def validate(self, val_dataset, arch_idx: int, prun_mode=None,
                 max_items: Optional[int] = None) -> List[float]:
        """mIoU of all five heads (train_search.py:260-271), one forward an
        image. The arch's widths are sampled once a call from a generator
        seeded 0. With a mesh, rank r takes items r, r + world, ... and the
        counts are summed over ranks, so every rank returns the same."""
        c = self.config
        self.model.eval()
        ap = self.arch_params[arch_idx].detached()
        mode = prun_mode or self.prun_modes[arch_idx]
        draws = to_device(draw_noise(ap.ratios, mode, self.nw,
                                     torch.Generator().manual_seed(0)),
                          self.device)
        ratios = sample_ratios(ap.ratios, mode, self.nw, noise=draws)
        n = min(len(val_dataset), max_items or len(val_dataset))
        hists = torch.zeros((5, c.num_classes, c.num_classes),
                            dtype=torch.int64, device=self.device)
        rank, world = ((0, 1) if self.mesh is None
                       else (self.mesh.rank, self.mesh.world))
        for i in range(rank, n, world):
            s = val_dataset[i]
            img = eval_preprocess(s["data"], c.data.image_mean,
                                  c.data.image_std)
            x, label = to_device(
                (torch.from_numpy(img[None]),
                 torch.from_numpy(s["label"][None].astype(np.int64))),
                self.device)
            preds = self.model(x, arch_idx, ap.alphas, ap.betas, ratios)
            for k, p in enumerate(preds):
                hists[k] += confusion_hist(torch.argmax(p, -1), label,
                                           c.num_classes)
        if self.mesh is not None:
            self.mesh.all_reduce_(hists)
        hists = hists.cpu().numpy()
        return [compute_score(hists[k])[1] for k in range(5)]

    def numpy_arch(self, arch_idx: int) -> ArchParams:
        ap = self.arch_params[arch_idx]
        f64 = lambda t: t.detach().cpu().double().numpy()
        return ArchParams(alphas=[f64(a) for a in ap.alphas],
                          betas=[None, f64(ap.betas[1]), f64(ap.betas[2])],
                          ratios=[f64(r) for r in ap.ratios])

    def arch_fps(self, arch_idx: int) -> Tuple[float, float]:
        """Decoded-net FPS estimates of the branch pairs [2, 0] and [2, 1]
        (arch_logging, train_search.py:274-303)."""
        c = self.config
        genos = decode_network(self.numpy_arch(arch_idx), self.wml, c.layers,
                               ignore_skip=False)
        fps = []
        for lasts in ([2, 0], [2, 1]):
            plan = build_plan(genos, lasts, Fch=c.Fch,
                              num_classes=c.num_classes,
                              stem_head_width=c.stem_head_width[arch_idx])
            fps.append(1000.0 / derived_latency_ms(self.lut, plan,
                                                   c.latency_input_hw))
        return fps[0], fps[1]

    # ---------------- persistence ----------------

    def load_weights(self, ckpt_dir: str):
        """Partial-match transfer of pretrained supernet weights
        (train_search.py:70-75: key and shape must match); returns what did
        not match."""
        path = os.path.join(ckpt_dir, "weights_ckpt")
        loaded = load(path if os.path.exists(path) else ckpt_dir)
        res = partial_load(self.model.state_dict(), loaded["model"])
        self.model.load_state_dict(res.state)
        return res

    def _resume_payload(self, epoch: int) -> Dict:
        """What an exact resume needs: weights and BN statistics, both
        optimizers' states (the weight update count sets the staircase),
        the arch parameters, the controller's latency weights and the epoch
        cursor (the reference checkpointed no optimizer state)."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "arch_params": {idx: [t.detach() for t in ap.tensors()]
                            for idx, ap in self.arch_params.items()},
            "arch_optimizer": self.arch_optimizer.state_dict(),
            "controller_weights": list(self.controller.weights),
            "epoch": epoch,
        }

    def restore(self, save_dir: str) -> int:
        """Restore a full search or pretrain state; returns the next epoch
        to run (0 if there is no resume checkpoint)."""
        path = os.path.join(save_dir, "resume_ckpt")
        if not os.path.exists(path):
            return 0
        loaded = load(path)
        self.model.load_state_dict(loaded["model"])
        self.optimizer.load_state_dict(loaded["optimizer"])
        self.step = int(loaded["step"])
        with torch.no_grad():
            for idx, ap in self.arch_params.items():
                for t, v in zip(ap.tensors(), loaded["arch_params"][idx]):
                    t.copy_(v)
        self.arch_optimizer.load_state_dict(loaded["arch_optimizer"])
        self.controller.weights = [float(w)
                                   for w in loaded["controller_weights"]]
        return int(loaded["epoch"]) + 1

    def save(self, save_dir: str, epoch: int, metrics: Optional[dict] = None):
        """weights_ckpt, resume_ckpt, and arch_{idx}.npz and
        arch_{idx}_{epoch}.npz in the JAX package's format. `metrics` maps
        arch_idx -> {mIoU02, latency02, mIoU12, latency12}, so each arch's
        file carries its own numbers (the reference stamps the last arch's
        into every file, train_search.py:185-202; PARITY.md). A flat
        {mIoU02, ...} dict applies to every arch. With a mesh rank 0 writes
        them and every rank waits until it has."""
        if self.mesh is not None and self.mesh.rank:
            self.mesh.barrier()
            return
        os.makedirs(save_dir, exist_ok=True)
        save(os.path.join(save_dir, "weights_ckpt"),
             {"model": self.model.state_dict()})
        save(os.path.join(save_dir, "resume_ckpt"),
             self._resume_payload(epoch))
        metrics = metrics or {}
        for idx in range(len(self.arch_params)):
            per_arch = metrics.get(idx)
            m = per_arch if isinstance(per_arch, dict) else metrics
            arch = self.numpy_arch(idx)
            for path in (os.path.join(save_dir, f"arch_{idx}.npz"),
                         os.path.join(save_dir, f"arch_{idx}_{epoch}.npz")):
                save_arch(path, arch,
                          mIoU02=m.get("mIoU02"), latency02=m.get("latency02"),
                          mIoU12=m.get("mIoU12"), latency12=m.get("latency12"))
        if self.mesh is not None:
            self.mesh.barrier()


def run_search(config: SearchConfig, val_dataset=None, epochs=None,
               niters=None, save_dir=None, max_eval_items=None,
               lut: Optional[LatencyLUT] = None,
               plot_genotypes: bool = False, resume: bool = False,
               mesh=None, dataset_cls=None, save_every: int = 1,
               device: Union[str, torch.device] = "cuda") -> SearchEngine:
    """The full driver (train_search.py:36-212): pretrain when
    config.pretrain is true, else bi-level search with latency control.
    Scalars go to save_dir/metrics.jsonl (and TensorBoard where it
    imports). With `plot_genotypes`, each search epoch's decoded genotypes
    go to the writer as figures (needs matplotlib), as the reference's
    arch_logging renders them (train_search.py:274-303). `mesh`: this rank
    of a data-parallel search (its loaders make only its shard of each
    batch; rank 0 writes the scalars and figures)."""
    pretrain = bool(config.pretrain)
    update_arch = not pretrain
    engine = SearchEngine(config, lut=lut, device=device, mesh=mesh)
    start_epoch = 0
    if resume and save_dir:
        start_epoch = engine.restore(save_dir)
        if start_epoch:
            logger.info("resumed from %s at epoch %d", save_dir, start_epoch)
    if start_epoch == 0 and not pretrain and config.load_path:
        engine.load_weights(config.load_path)
    writer = None
    if save_dir and (mesh is None or mesh.rank == 0):
        from ..utils.logging import MetricWriter
        writer = MetricWriter(save_dir)

    # one shared shuffled permutation -> balanced disjoint weight / arch
    # halves (train_search.py:109-112)
    perm = None
    if not config.data.synthetic:
        perm = list(np.random.default_rng(config.seed).permutation(
            config.data.num_train_imgs))
    dataset_cls = dataset_cls or Cityscapes
    shard = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    loader_model = get_train_loader(config, dataset_cls,
                                    portion=config.train_portion,
                                    index_select=perm, shard=shard)
    loader_arch = get_train_loader(config, dataset_cls,
                                   portion=config.train_portion - 1,
                                   index_select=perm, shard=shard)
    if val_dataset is None:
        # dataset-free smoke: a tiny synthetic val set
        val_dataset = SyntheticDataset(
            length=max_eval_items or 8,
            hw=(config.eval.eval_height, config.eval.eval_width),
            num_classes=config.num_classes)

    epochs = epochs or config.nepochs
    try:
        for epoch in range(start_epoch, epochs):
            stats = engine.train_epoch(loader_model, loader_arch, epoch,
                                       pretrain, update_arch, niters=niters)
            logger.info("epoch %d: %s", epoch, stats)
            if writer:
                for k, v in stats.items():
                    if not isinstance(v, list):
                        writer.add_scalar(f"train/{k}", v, epoch)
            metrics = (_pretrain_eval(engine, val_dataset, epoch,
                                      max_eval_items, writer) if pretrain
                       else _search_eval(engine, val_dataset, epoch,
                                         max_eval_items, writer,
                                         plot_genotypes))
            if save_dir and ((epoch + 1) % save_every == 0
                             or epoch == epochs - 1):
                engine.save(save_dir, epoch, metrics)
    finally:
        loader_model.close()
        loader_arch.close()
        if writer:
            writer.close()
    return engine


def _pretrain_eval(engine: SearchEngine, val_dataset, epoch: int,
                   max_items, writer) -> Dict:
    for mode in ("min", "max", "random"):
        mious = engine.validate(val_dataset, 0, prun_mode=mode,
                                max_items=max_items)
        logger.info("epoch %d pretrain val[%s]: %s", epoch, mode,
                    ["%.3f" % m for m in mious])
        if writer:
            for i, m in enumerate(mious):
                writer.add_scalar(f"mIoU/val_{mode}_{VALID_NAMES[i]}", m,
                                  epoch)
    return {}


def _search_eval(engine: SearchEngine, val_dataset, epoch: int, max_items,
                 writer, plot_genotypes: bool = False) -> Dict:
    """Each arch's five mIoUs and decoded FPS, the controller's update of
    its latency weight and, with `plot_genotypes`, its genotype figures;
    returns the per-arch metrics `save` stamps."""
    metrics = {}
    for idx in range(len(engine.arch_params)):
        name = "teacher" if idx == 0 else "student"
        mious = engine.validate(val_dataset, idx, max_items=max_items)
        fps0, fps1 = engine.arch_fps(idx)
        metrics[idx] = {"mIoU02": mious[3], "mIoU12": mious[4],
                        "latency02": 1000.0 / fps0,
                        "latency12": 1000.0 / fps1}
        w = engine.controller.update(idx, fps0, fps1)
        logger.info("epoch %d arch %d val: %s fps=(%.1f, %.1f) lat_w=%g",
                    epoch, idx, ["%.3f" % m for m in mious], fps0, fps1, w)
        if writer:
            for i, m in enumerate(mious):
                writer.add_scalar(f"mIoU/val_{name}_{VALID_NAMES[i]}", m,
                                  epoch)
            writer.add_scalar(f"arch/fps0_{name}", fps0, epoch)
            writer.add_scalar(f"arch/fps1_{name}", fps1, epoch)
            writer.add_scalar(f"arch/latency_weight_{name}", w, epoch + 1)
            writer.add_scalar(f"objective/val_{name}_8s_32s",
                              objective_acc_lat(mious[3], 1000.0 / fps0),
                              epoch)
            writer.add_scalar(f"objective/val_{name}_16s_32s",
                              objective_acc_lat(mious[4], 1000.0 / fps1),
                              epoch)
            if plot_genotypes:
                _plot_genotypes(engine, idx, name, epoch, writer)
    return metrics


def _plot_genotypes(engine: SearchEngine, idx: int, name: str, epoch: int,
                    writer) -> None:
    """The arch's decoded cells per branch (`arch/ops{last}_{name}`) and
    its three branches' paths and widths (`arch/path_width_{name}`), under
    the JAX package's tags (loop.py:569-585)."""
    import matplotlib.pyplot as plt
    from ..utils.plotting import plot_op, plot_path_width
    genos = decode_network(engine.numpy_arch(idx), engine.wml,
                           engine.config.layers)
    figures = {f"arch/ops{last}_{name}": plot_op(g.ops, g.path, g.widths)
               for last, g in genos.items()}
    figures[f"arch/path_width_{name}"] = plot_path_width(
        [2, 1, 0], [genos[b].path for b in (2, 1, 0)],
        [genos[b].widths for b in (2, 1, 0)])
    for tag, fig in figures.items():
        writer.add_figure(tag, fig, epoch)
        plt.close(fig)
