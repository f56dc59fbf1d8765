"""Teacher/student training: optimizer, train state, the train step.

Counterpart of the JAX package's train/loop.py (the reference's
train/train.py:219-271):

  student loss = OHEM(p8) + 0.2 OHEM(p16) + 0.2 OHEM(p32)
               + KL(log_softmax(student p8), softmax(teacher p8))
  teacher loss = the same without the KL term
  optimizer    = SGD, momentum 0.9, weight decay 5e-4 added to the gradient
                 of every parameter (BN scale and bias and conv biases too),
                 lr x0.992 per epoch as a staircase

`torch.optim.SGD(momentum, weight_decay)` is the JAX package's
`optax.chain(add_decayed_weights, sgd(momentum))` update for update: its
first momentum buffer is the gradient itself, as optax's trace from zeros is.
The learning rate is not stepped per epoch (`ExponentialLR.step()` drifts
when a run resumes mid-epoch); it is set on the param groups before every
update from the count k of earlier updates, lr * decay^(k // steps_per_epoch),
optax's `exponential_decay(staircase=True)`. `grad_clip` (off by default, as
in the JAX package, whose training session never sets it) scales the raw
gradients by optax's global-norm clip before the update, so the weight
decay that `SGD.step` adds comes after it: optax's
`chain(add_decayed_weights, sgd)` order behind `clip_by_global_norm`.

Data parallelism (`mesh`): each rank runs the step on its shard with the
global-batch losses and sync BN, and the gradients are sum-reduced in one
flat bucket before the update, so every rank makes the one-rank update on
the concatenated batch (`DistributedDataParallel` averages gradients, which
is not the gradient of the global-count losses).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

from ..eval.metrics import batch_intersection_union
from ..parallel.mesh import sync_batchnorm_
from ..utils import profiling
from .loss import kl_distillation, ohem_cross_entropy


@dataclasses.dataclass
class TrainState:
    """The trained module, its optimizer and the count of updates made."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 0.01,
                   momentum: float = 0.9, weight_decay: float = 5e-4,
                   lr_decay: float = 0.992,
                   steps_per_epoch: int = 1000) -> torch.optim.SGD:
    """SGD whose param groups also carry the staircase schedule
    (`initial_lr`, `lr_decay`, `steps_per_epoch`), so the optimizer's
    state_dict holds it and `set_learning_rate` reads it."""
    opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                          weight_decay=weight_decay)
    for group in opt.param_groups:
        group.update(initial_lr=lr, lr_decay=lr_decay,
                     steps_per_epoch=steps_per_epoch)
    return opt


def learning_rate(group: Dict, step: int) -> float:
    """The staircase rate of update number `step` (0-based)."""
    return group["initial_lr"] * group["lr_decay"] ** (
        step // group["steps_per_epoch"])


def set_learning_rate(optimizer: torch.optim.Optimizer, step: int) -> None:
    for group in optimizer.param_groups:
        group["lr"] = learning_rate(group, step)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax's `clip_by_global_norm` in place: g * c / max(|g|, c) with
    |g| the norm over every tensor (torch's `clip_grad_norm_` scales by
    c / (|g| + 1e-6) instead). Reads nothing to the host; returns |g|."""
    total = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        list(grads))))
    scale = max_norm / torch.clamp(total, min=max_norm)
    torch._foreach_mul_(list(grads), scale)
    return total


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               teacher: Optional[torch.nn.Module] = None, *,
               min_kept: int = 131072, ignore_label: int = 255,
               thresh: float = 0.7, aux_weight: float = 0.2,
               num_classes: int = 19, mesh=None,
               grad_clip: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """One update of `state` in place on a batch: images (N, H, W, 3) fp32,
    labels (N, H, W) integer, on the model's device. `teacher` (frozen, in
    eval mode, no gradient) adds the KL distillation term. With `mesh` (a
    `parallel.Mesh`) the batch is this rank's shard of the global batch,
    and the update is the one-rank update on the global batch. `grad_clip`
    clips the gradients' global norm (of the global batch's gradients) to
    it before the update.

    Returns {loss, loss_kl, inter, union} as tensors on the device (no host
    read): the loss before the update, and the per-class intersection and
    union of p8's class map with the labels (of the global batch).

    Spans (utils/profiling.py): `train.forward` (the model's forward, and
    the teacher's), `train.loss` (OHEM x3, KL), `train.backward` and
    `train.optimizer` (zero_grad first; the gradients' reduce, clip, the
    learning rate and the update last)."""
    model, opt = state.model, state.optimizer
    with profiling.span("train.optimizer"):
        opt.zero_grad(set_to_none=True)
    with profiling.span("train.forward"):
        model.train()
        sync_batchnorm_(model, mesh)
        p8, p16, p32 = model(images)
    ohem = lambda p: ohem_cross_entropy(p, labels, ignore_label, thresh,
                                        min_kept, mesh=mesh)
    with profiling.span("train.loss"):
        loss = ohem(p8)
        for aux in (p16, p32):
            if aux is not None:
                loss = loss + aux_weight * ohem(aux)
        loss_kl = torch.zeros((), dtype=loss.dtype, device=images.device)
    if teacher is not None:
        with profiling.span("train.forward"):
            teacher.eval()
            with torch.no_grad():
                t8 = teacher(images)
        with profiling.span("train.loss"):
            loss_kl = kl_distillation(p8, t8, mesh=mesh)
            loss = loss + loss_kl
    with profiling.span("train.backward"):
        loss.backward()
    with profiling.span("train.optimizer"):
        grads = [p.grad for g in opt.param_groups for p in g["params"]
                 if p.grad is not None]
        if mesh is not None:
            mesh.reduce_grads_(grads)
        if grad_clip is not None:
            clip_by_global_norm_(grads, grad_clip)
        set_learning_rate(opt, state.step)
        opt.step()
    state.step += 1
    inter, union = batch_intersection_union(p8.detach(), labels, num_classes)
    losses = torch.stack([loss.detach(), loss_kl.detach()])
    if mesh is not None:
        # each rank's loss is its share of the global one
        mesh.all_reduce_(losses)
        counts = mesh.all_reduce_(torch.cat([inter, union]))
        inter, union = counts[:num_classes], counts[num_classes:]
    return {"loss": losses[0], "loss_kl": losses[1],
            "inter": inter, "union": union}


def make_eval_step(model: torch.nn.Module) -> Callable:
    """images (N, H, W, 3) -> int32 class map (N, H, W): the argmax of the
    eval-mode full-resolution logits."""
    @torch.no_grad()
    def eval_fn(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        return torch.argmax(model(images), dim=-1).int()
    return eval_fn
