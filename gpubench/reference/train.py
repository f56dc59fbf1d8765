"""The plain training step of FasterSeg's teacher: OHEM losses and SGD.

Frozen copies of the published equations (FasterSeg train/train.py,
tools/seg_opr/loss_opr.py `ProbOhemCrossEntropy2d`):

  loss = OHEM(p8) + 0.2 OHEM(p16) + 0.2 OHEM(p32)
  OHEM: keep the valid pixels whose true-class probability is at most
        max(thresh, the k-th smallest such probability over the batch),
        k = min(min_kept, pixels), invalid pixels counted as probability 1;
        the loss is the mean negative log-probability over those kept
  SGD:  d = g + weight_decay * w; buf = d at the first step, else
        momentum * buf + d; w -= lr * buf

Autograd differentiates the plain network of net.py in train mode.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .net import Net, precision_flags, upcast
from .plan import Plan


def ohem(logits: torch.Tensor, labels: torch.Tensor, ignore: int,
         thresh: float, min_kept: int) -> torch.Tensor:
    """logits (N, C, H, W) fp32, labels (N, H, W) integer."""
    labels = labels.long()
    valid = labels != ignore
    t = torch.where(valid, labels, 0)
    logp = torch.log_softmax(upcast(logits), 1)
    picked = torch.gather(logp, 1, t[:, None])[:, 0]
    with torch.no_grad():
        p_true = torch.where(valid, picked.exp(), torch.ones_like(picked))
        flat = p_true.reshape(-1)
        k = min(min_kept, flat.numel())
        cut = torch.maximum(torch.kthvalue(flat, k).values,
                            torch.tensor(thresh, device=flat.device))
        keep = valid & (p_true <= cut)
    w = keep.to(picked.dtype)
    return -(picked * w).sum() / w.sum().clamp(min=1e-12)


def loss(plan: Plan, p: Dict[str, torch.Tensor], images: torch.Tensor,
         labels: torch.Tensor, hp: Dict, precision: str = "fp32"
         ) -> torch.Tensor:
    """The teacher's loss on NCHW images, in train mode."""
    p8, p16, p32 = Net(plan, p, precision, train=True).forward(images)
    f = lambda q: ohem(q, labels, hp["ignore_label"], hp["ohem_thresh"],
                       hp["min_kept"])
    total = f(p8)
    for aux in (p16, p32):
        if aux is not None:
            total = total + hp["aux_weight"] * f(aux)
    return total


def run_steps(plan: Plan, p0: Dict[str, torch.Tensor], batches: List,
              hp: Dict, precision: str = "fp32") -> Dict:
    """SGD steps from parameters p0 on `batches` [(images NHWC, labels
    NHW), ...]. Returns the loss of each step, the gradients of the first
    step and the parameters after the last, by name (trained leaves
    only: the conv weights and biases and BN scales and offsets)."""
    names = [n for n in p0 if not n.endswith(("running_mean", "running_var",
                                               "num_batches_tracked"))]
    w = {n: p0[n].detach().clone().requires_grad_(True)
         for n in names}
    const = {n: t for n, t in p0.items() if n not in w}
    buf: Dict[str, torch.Tensor] = {}
    losses, first_grads = [], None
    with precision_flags(precision):
        for step, (x, y) in enumerate(batches):
            params = dict(const, **w)
            value = loss(plan, params, x.permute(0, 3, 1, 2).contiguous(),
                         y, hp, precision)
            grads = torch.autograd.grad(value, list(w.values()),
                                        allow_unused=True)
            losses.append(float(value.detach()))
            g = {n: gr for n, gr in zip(w, grads) if gr is not None}
            if first_grads is None:
                first_grads = {n: t.detach().clone() for n, t in g.items()}
            with torch.no_grad():
                for n, gr in g.items():
                    d = gr + hp["weight_decay"] * w[n]
                    buf[n] = d if n not in buf else hp["momentum"] * buf[n] + d
                    w[n] -= hp["lr"] * buf[n]
    return {"losses": losses, "first_grads": first_grads,
            "params": {n: t.detach() for n, t in w.items()}}
