"""Segmentation losses on NHWC logits and integer NHW labels.

Counterpart of the JAX package's train/loss.py, with its semantics:

* `ohem_cross_entropy`: ProbOhemCrossEntropy2d (tools/seg_opr/loss_opr.py:
  43-93): keep the pixels whose true-class probability is at most
  max(thresh, the k-th smallest such probability); invalid pixels count as
  probability 1, so with fewer than `min_kept` valid pixels the loss is
  plain CE over them, with no branch on the data.
* `kl_distillation`: nn.KLDivLoss()(log_softmax(student), softmax(teacher))
  with torch's elementwise mean over N*H*W*C (train/train.py:64,256-260).
* `ohem_ce_topk`: OhemCELoss (search/loss.py:65-81).
* `focal_loss`, `soft_cross_entropy`: search/loss.py:32-63.

Logits are taken in fp32 (`ops.conv.upcast`). The selection masks carry no
gradient.

With `mesh` (a `parallel.Mesh`; each rank holds an equal shard of the global
batch) every function returns this rank's share of the JAX package's loss on
the global batch, whose reductions are global under SPMD: its sum divided by
the global count (counts reduced without gradient; torch's elementwise means
divided by the world), with OHEM's k-th smallest probability and the top-k
cutoff taken over the global batch. The ranks' shares sum to the global
loss, and so do their gradients once reduced. Without a mesh the functions
are as above.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.conv import upcast

# Cityscapes class weights (loss_opr.py:52-55), for use_weight=True.
CITYSCAPES_CLASS_WEIGHTS = (
    0.8373, 0.918, 0.866, 1.0345, 1.0166, 0.9969, 0.9754, 1.0489,
    0.8786, 1.0023, 0.9539, 0.9843, 1.1116, 0.9037, 1.0865, 1.0955,
    1.0865, 1.1529, 1.0507)


def _pick(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x[..., t] per pixel."""
    return torch.gather(x, -1, t[..., None])[..., 0]


def _count(c: torch.Tensor, mesh) -> torch.Tensor:
    """A count (no gradient) over the global batch."""
    return c if mesh is None else mesh.all_reduce_(c.detach().clone())


def _world(mesh) -> int:
    return 1 if mesh is None else mesh.world


def _global_head(head: torch.Tensor, k: int, mesh, descending: bool
                 ) -> torch.Tensor:
    """The first k values of the global batch's sorted values, from each
    rank's own first k (`head`, sorted; fewer where its shard is smaller):
    the global k smallest (largest) lie among the ranks' k smallest
    (largest)."""
    if mesh is None:
        return head
    fill = float("-inf") if descending else float("inf")
    padded = head.new_full((k,), fill)
    padded[:head.numel()] = head
    return torch.sort(mesh.gather(padded).reshape(-1),
                      descending=descending).values[:k]


def _weighted_nll(logp: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                  class_weight: Optional[torch.Tensor], mesh=None
                  ) -> torch.Tensor:
    nll = -_pick(logp, t)
    if class_weight is not None:
        w = torch.as_tensor(class_weight, dtype=nll.dtype,
                            device=nll.device)[t] * valid
    else:
        w = valid.to(nll.dtype)
    return torch.sum(nll * w) / torch.clamp(_count(torch.sum(w), mesh),
                                            min=1e-12)


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  ignore_label: int = 255,
                  class_weight: Optional[torch.Tensor] = None, *,
                  mesh=None) -> torch.Tensor:
    """Mean CE over non-ignored pixels (torch CrossEntropyLoss semantics:
    with class weights the mean is weighted by the target's class weight)."""
    target = target.long()
    valid = target != ignore_label
    t = torch.where(valid, target, 0)
    logp = torch.log_softmax(upcast(logits), -1)
    return _weighted_nll(logp, t, valid, class_weight, mesh)


def ohem_threshold(p_true: torch.Tensor, thresh: float, min_kept: int,
                   mesh=None) -> torch.Tensor:
    """OHEM's probability threshold: max(thresh, the k-th smallest of
    `p_true` over the batch (the global one with `mesh`)), k = min(min_kept,
    pixels)."""
    threshold = torch.tensor(thresh, dtype=p_true.dtype,
                             device=p_true.device)
    if min_kept > 0:
        flat = p_true.reshape(-1)
        k = min(min_kept, flat.numel() * _world(mesh))
        head = _global_head(torch.sort(flat).values[:k], k, mesh,
                            descending=False)
        threshold = torch.maximum(head[k - 1], threshold)
    return threshold


def ohem_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                       ignore_label: int = 255, thresh: float = 0.6,
                       min_kept: int = 256,
                       class_weight: Optional[torch.Tensor] = None, *,
                       mesh=None) -> torch.Tensor:
    """Probability-threshold online hard example mining CE
    (loss_opr.py:63-93): threshold = max(thresh, k-th smallest true-class
    probability, k = min(min_kept, pixels)); keep valid pixels with
    p_true <= threshold; mean CE over them."""
    logits = upcast(logits)
    target = target.long()
    valid = target != ignore_label
    t = torch.where(valid, target, 0)
    if min_kept > 0 or thresh < 1.0:
        with torch.no_grad():
            p_true = _pick(torch.softmax(logits, -1), t)
            p_true = torch.where(valid, p_true, 1.0)   # masked_fill_(~valid, 1)
            threshold = ohem_threshold(p_true, thresh, min_kept, mesh)
            valid = valid & (p_true <= threshold)
            t = torch.where(valid, t, 0)
    logp = torch.log_softmax(logits, -1)
    return _weighted_nll(logp, t, valid, class_weight, mesh)


def kl_distillation(student_logits: torch.Tensor,
                    teacher_logits: torch.Tensor, *, mesh=None
                    ) -> torch.Tensor:
    """nn.KLDivLoss() default 'mean': the elementwise mean of
    p_t * (log p_t - log p_s) over every element (train/train.py:64)."""
    logp_s = torch.log_softmax(upcast(student_logits), -1)
    logp_t = torch.log_softmax(upcast(teacher_logits), -1)
    p_t = torch.softmax(upcast(teacher_logits), -1)
    return torch.mean(p_t * (logp_t - logp_s)) / _world(mesh)


def ohem_ce_topk(logits: torch.Tensor, target: torch.Tensor, n_min: int,
                 thresh: float = 0.7, ignore_label: int = 255, *,
                 mesh=None) -> torch.Tensor:
    """OhemCELoss (search/loss.py:65-81): per-pixel CE; keep the pixels with
    loss > -log(thresh), or, if fewer than n_min qualify, those above the
    (n_min+1)-th largest loss; mean over the kept."""
    target = target.long()
    valid = target != ignore_label
    t = torch.where(valid, target, 0)
    logp = torch.log_softmax(upcast(logits), -1)
    nll = torch.where(valid, -_pick(logp, t), 0.0).reshape(-1)
    with torch.no_grad():
        loss_thresh = -torch.log(torch.tensor(thresh, dtype=nll.dtype,
                                              device=nll.device))
        i = min(n_min, nll.numel() * _world(mesh) - 1)
        head = _global_head(torch.sort(nll, descending=True).values[:i + 1],
                            i + 1, mesh, descending=True)
        cutoff = torch.where(head[i] > loss_thresh, head[i], loss_thresh)
        kept = nll > cutoff
    # torch keeps loss[loss > thresh] (strict); mean over the kept
    return torch.sum(torch.where(kept, nll, 0.0)) / torch.clamp(
        _count(torch.sum(kept), mesh), min=1)


def focal_loss(logits: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
               ignore_label: int = 255, *, mesh=None) -> torch.Tensor:
    """Multi-class focal loss (search/loss.py:32-50)."""
    target = target.long()
    valid = target != ignore_label
    t = torch.where(valid, target, 0)
    logp_t = _pick(torch.log_softmax(upcast(logits), -1), t)
    loss = -((1 - torch.exp(logp_t)) ** gamma) * logp_t
    loss = torch.where(valid, loss, 0.0)
    return torch.sum(loss) / torch.clamp(_count(torch.sum(valid), mesh),
                                         min=1)


def soft_cross_entropy(logits: torch.Tensor, soft_target: torch.Tensor,
                       *, mesh=None) -> torch.Tensor:
    """SoftCrossEntropyLoss2d (search/loss.py:53-63): minus the batch mean
    of sum(target * log_softmax(pred))."""
    logp = torch.log_softmax(upcast(logits), -1)
    return -torch.sum(soft_target * logp) / (logits.shape[0] * _world(mesh))
