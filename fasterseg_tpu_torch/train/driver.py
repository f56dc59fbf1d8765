"""Train-from-scratch driver: teacher, then student with KL distillation.

Counterpart of the JAX package's train/driver.py (the reference's
train/train.py:42-295). Decodes the searched genotypes (arch_0 = teacher
with ignore_skip, arch_1 = student), picks the output branch pair by the
stored search-time accuracy/latency objective (train.py:102-105), builds the
derived networks with the JAX package's training init, and trains:

  teacher:  OHEM(p8) + 0.2 OHEM(p16) + 0.2 OHEM(p32)
  student:  + KL(log_softmax(student p8), softmax(teacher p8)), the teacher
            frozen in eval mode (train.py:225,249-260)

The step is PyTorch autograd over the plain network (`F.conv2d` and the
matrix resizes); no hand-written kernel has a backward. Evaluation folds the
current weights into an `InferenceRunner` in fp32, so on the card it runs
the hand-written conv kernels. Eval-only and test-submission paths included
(train.py:155-176, train/test.py).

With `mesh` (a `parallel.Mesh`, one per rank) training is data-parallel as
the JAX package's SPMD session is: weights replicated from rank 0, each rank
loading and stepping on its shard of every global batch (sync BN, global
losses, reduced gradients), evaluation sharded over the items with its
counts reduced, and checkpoints written by rank 0.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.genotype import ArchParams, decode_network
from ..core.plan import NetworkPlan, build_plan, select_lasts
from ..data import Cityscapes, get_train_loader
from ..data.preprocess import eval_preprocess
from ..eval.evaluator import EvalResult, Evaluator
from ..eval.metrics import SegMetrics
from ..models import DerivedNet, InferenceRunner
from ..kernels import resolve_device
from ..parallel.mesh import replicate
from ..utils import profiling
from ..utils.checkpoint import PartialLoad, load, partial_load, save
from ..utils.weights import init_jax_draw_
from .loop import TrainState, make_optimizer, train_step

logger = logging.getLogger("fasterseg_tpu_torch.train")

_METRIC_KEYS = ("mIoU02", "latency02", "mIoU12", "latency12")


def load_arch_any(path: str) -> Tuple[ArchParams, Dict[str, float]]:
    """Arch params and search-time metrics from the repo's .npz or a
    reference .pt artifact (alpha_/beta_/ratio_ tensors, read with
    torch.load as the reference wrote them)."""
    if path.endswith(".pt"):
        state = torch.load(path, map_location="cpu", weights_only=False)
        idx = next(k for k in state if k.startswith("alpha_")).split("_")[1]
        arch = ArchParams(
            alphas=[state[f"alpha_{idx}_{s}"].detach().numpy()
                    for s in (0, 1, 2)],
            betas=[None, state[f"beta_{idx}_1"].detach().numpy(),
                   state[f"beta_{idx}_2"].detach().numpy()],
            ratios=[state[f"ratio_{idx}_{s}"].detach().numpy()
                    for s in (0, 1, 2)])
        return arch, {k: float(state[k]) for k in _METRIC_KEYS if k in state}
    d = np.load(path)
    return (ArchParams.from_npz(path),
            {k: float(d[k]) for k in _METRIC_KEYS if k in d})


def build_model_from_arch(config: TrainConfig, arch_path: str,
                          arch_idx: int, stem_head_width, seed: int
                          ) -> Tuple[DerivedNet, NetworkPlan, list]:
    """Decode, select branches and build the DerivedNet with the training
    init seeded by `seed` (train.py:90-105): the JAX package's own draw
    for that seed (`init_jax_draw_`)."""
    arch, metrics = load_arch_any(arch_path)
    genos = decode_network(arch, config.width_mult_list, config.layers,
                           ignore_skip=(arch_idx == 0))
    if all(k in metrics for k in _METRIC_KEYS):
        lasts = select_lasts(*(metrics[k] for k in _METRIC_KEYS))
    else:
        lasts = [2, 1]
    plan = build_plan(genos, lasts, Fch=config.Fch,
                      num_classes=config.data.num_classes,
                      stem_head_width=stem_head_width)
    return init_jax_draw_(DerivedNet(plan), seed), plan, lasts


class TrainSession:
    """The trained network (the student, or the teacher in teacher mode),
    its optimizer and, in student mode, the frozen teacher.

    `device` defaults to CUDA and raises where there is none; tests pass
    "cpu". With `mesh` the session runs on the mesh's device, one rank of a
    data-parallel group (unless `config.is_eval`, the global batch must
    divide over its ranks)."""

    def __init__(self, config: TrainConfig, arch_dir: str,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        self.config = c = config
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
            # evaluation shards images, not the training batch
            if not c.is_eval and c.data.batch_size % mesh.world:
                raise ValueError(f"global batch {c.data.batch_size} must "
                                 f"divide over {mesh.world} ranks")
        self.device = resolve_device(device)
        self.models: Dict[int, DerivedNet] = {}
        self.plans: Dict[int, NetworkPlan] = {}
        for i, arch_idx in enumerate(c.arch_idx):
            path = os.path.join(arch_dir, f"arch_{arch_idx}.npz")
            if not os.path.exists(path):
                path = os.path.join(arch_dir, f"arch_{arch_idx}.pt")
            net, plan, lasts = build_model_from_arch(
                c, path, arch_idx, c.stem_head_width[i], c.seed + arch_idx)
            self.models[arch_idx] = replicate(net.to(self.device), mesh)
            self.plans[arch_idx] = plan
            logger.info("arch %d: lasts=%s ops=%s", arch_idx, lasts,
                        [g.ops for g in plan.genotypes])
        self.is_student = len(c.arch_idx) > 1
        self.student_idx = c.arch_idx[-1]
        self.teacher = self.models[0] if self.is_student else None
        if self.teacher is not None:
            self.teacher.eval().requires_grad_(False)
        net = self.models[self.student_idx]
        self.state = TrainState(net, make_optimizer(
            net.parameters(), c.lr, c.momentum, c.weight_decay, c.lr_decay,
            c.niters_per_epoch))
        self.step_kwargs = dict(min_kept=c.min_kept(),
                                ignore_label=c.data.ignore_label,
                                aux_weight=c.aux_weight,
                                num_classes=c.data.num_classes)
        self.metric = SegMetrics(c.data.num_classes)

    @property
    def model(self) -> DerivedNet:
        return self.state.model

    def step(self, images: torch.Tensor, labels: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        """One update on a batch (this rank's shard of it, with a mesh)
        already on the session's device; the unit span `train.step`."""
        with profiling.span("train.step"):
            return train_step(self.state, images, labels, self.teacher,
                              mesh=self.mesh, **self.step_kwargs)

    def load_weights(self, ckpt_path: str, arch_idx: Optional[int] = None
                     ) -> PartialLoad:
        """Partial-match load of a weights checkpoint (a state_dict written
        by `save`) into the network of `arch_idx` (default: the trained
        one); returns what did not match."""
        net = self.models[self.student_idx if arch_idx is None else arch_idx]
        res = partial_load(net.state_dict(), load(ckpt_path))
        net.load_state_dict(res.state)
        return res

    def load_teacher_weights(self, ckpt_path: str) -> PartialLoad:
        """The frozen teacher for distillation (train.py:124-129)."""
        return self.load_weights(ckpt_path, 0)

    def train_epoch(self, loader, epoch: int, niters: int) -> Dict:
        """`niters` updates on the loader's batches of `epoch`. Losses and
        the online mIoU counts stay on the device until the epoch ends."""
        loader.seek(epoch)  # batch sequence = f(epoch) -> exact resume
        it = iter(loader)
        losses, kls, inter, union = [], [], 0, 0
        for _ in range(niters):
            x, y = next(it)
            m = self.step(torch.from_numpy(x).to(self.device),
                          torch.from_numpy(y).to(self.device))
            losses.append(m["loss"])
            kls.append(m["loss_kl"])
            inter, union = inter + m["inter"], union + m["union"]
        self.metric.reset()
        self.metric.update(inter, union)
        losses, kls = torch.stack(losses).tolist(), torch.stack(kls).tolist()
        return {"loss": losses[-1], "loss_kl": kls[-1], "losses": losses,
                "losses_kl": kls, "train_mIoU": self.metric.get_scores()}

    def runner(self) -> InferenceRunner:
        """An fp32 InferenceRunner of the trained network's current
        weights and running statistics (the conv kernels on the card)."""
        net = self.models[self.student_idx]
        return InferenceRunner(self.plans[self.student_idx], net,
                               dtype=torch.float32, device=self.device)

    def evaluate(self, val_dataset, max_items: Optional[int] = None,
                 mesh=None, spatial: bool = False) -> EvalResult:
        """Whole-image eval of the trained network with the config's
        protocol, through `runner()` rebuilt from the current weights;
        sharded over the session's mesh unless `mesh` names another, or with
        `spatial` each image split over H across its ranks (the runner's
        kernel forward on blocks, every conv with its halo rows)."""
        c = self.config
        ev = Evaluator(val_dataset, c.data.num_classes, c.data.image_mean,
                       c.data.image_std, self.runner().logits,
                       eval_scales=c.eval.eval_scale_array,
                       eval_flip=c.eval.eval_flip,
                       ignore_label=c.data.ignore_label, device=self.device,
                       mesh=self.mesh if mesh is None else mesh,
                       spatial=spatial)
        return ev.run(max_items=max_items)

    def save(self, save_dir: str, epoch: Optional[int] = None) -> None:
        """weights{idx}_ckpt (the state_dict), and with `epoch` also
        resume_ckpt (the full training state); with a mesh rank 0 writes
        them and every rank waits until it has."""
        if self.mesh is None or self.mesh.rank == 0:
            os.makedirs(save_dir, exist_ok=True)
            save(os.path.join(save_dir, f"weights{self.student_idx}_ckpt"),
                 self.model.state_dict())
            if epoch is not None:
                save(os.path.join(save_dir, "resume_ckpt"),
                     self._resume_payload(epoch))
        if self.mesh is not None:
            self.mesh.barrier()

    def _resume_payload(self, epoch: int) -> Dict:
        """Parameters and BN buffers, the optimizer state with its momentum
        buffers and schedule, the update count and the epoch cursor: what
        an exact resume needs (the reference never checkpointed the
        optimizer)."""
        return {"model": self.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict(),
                "step": self.state.step, "epoch": epoch}

    def restore(self, save_dir: str) -> int:
        """Restore the full training state; returns the next epoch to run
        (0 if there is no resume checkpoint)."""
        path = os.path.join(save_dir, "resume_ckpt")
        if not os.path.exists(path):
            return 0
        loaded = load(path)
        self.model.load_state_dict(loaded["model"])
        self.state.optimizer.load_state_dict(loaded["optimizer"])
        self.state.step = int(loaded["step"])
        return int(loaded["epoch"]) + 1


def write_test_predictions(session: TrainSession, dataset, out_dir: str,
                           max_items: Optional[int] = None,
                           remap=Cityscapes.train_id_to_label_id) -> None:
    """Submission writer (train/test.py:60-69): class maps through the fp32
    runner's `classmap`, train ids remapped (`remap`; None keeps them),
    written as PNGs. Needs cv2."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    runner = session.runner()
    mean, std = session.config.data.image_mean, session.config.data.image_std
    n = min(len(dataset), max_items or len(dataset))
    for i in range(n):
        s = dataset[i]
        x = torch.from_numpy(eval_preprocess(s["data"], mean, std)[None])
        pred = runner.classmap(x)[0].cpu().numpy().astype(np.uint8)
        if remap is not None:
            pred = remap(pred)
        name = os.path.splitext(os.path.basename(s["fn"]))[0] + ".png"
        cv2.imwrite(os.path.join(out_dir, name), pred)


def run_train(config: TrainConfig, arch_dir: str, val_dataset=None,
              epochs: Optional[int] = None, niters: Optional[int] = None,
              save_dir: Optional[str] = None,
              teacher_ckpt: Optional[str] = None, resume: bool = False,
              dataset_cls=Cityscapes,
              device: Union[str, torch.device] = "cuda",
              mesh=None) -> TrainSession:
    """The full driver (train.py:42-216): build, load the teacher, resume,
    then per epoch train, evaluate every `eval_every` epochs and save.
    `mesh`: this rank of a data-parallel group (its loader makes only its
    shard of each batch)."""
    session = TrainSession(config, arch_dir, device=device, mesh=mesh)
    if session.is_student and teacher_ckpt:
        session.load_teacher_weights(teacher_ckpt)
    start_epoch = 0
    if resume and save_dir:
        start_epoch = session.restore(save_dir)
        if start_epoch:
            logger.info("resumed from %s at epoch %d", save_dir, start_epoch)

    if config.is_eval:
        if val_dataset is None:
            raise ValueError("is_eval needs a val_dataset")
        logger.info("eval-only: %s", session.evaluate(val_dataset))
        return session

    loader = get_train_loader(
        config, dataset_cls, test=config.is_test,
        shard=(0, 1) if mesh is None else (mesh.rank, mesh.world))
    epochs = epochs or config.nepochs
    niters = niters or config.niters_per_epoch
    try:
        for epoch in range(start_epoch, epochs):
            stats = session.train_epoch(loader, epoch, niters)
            logger.info("epoch %d: %s", epoch, stats)
            if val_dataset is not None and (epoch + 1) % config.eval_every == 0:
                logger.info("epoch %d val: %s", epoch,
                            session.evaluate(val_dataset))
            if save_dir:
                session.save(save_dir, epoch)
    finally:
        loader.close()
    return session
