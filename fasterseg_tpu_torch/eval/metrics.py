"""Confusion-matrix segmentation metrics.

Counterpart of the JAX package's eval/metrics.py (the reference's
tools/seg_opr/metric.py hist_info/compute_score and the online training
metric search/seg_metrics.py). The counts are int64 tensors computed on the
tensors' own device; only `compute_score` and `SegMetrics` run on the host,
in numpy, on counts already there.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _valid(label: torch.Tensor, num_classes: int,
           ignore_label: int) -> torch.Tensor:
    return (label >= 0) & (label < num_classes) & (label != ignore_label)


def _bincount(idx: torch.Tensor, size: int) -> torch.Tensor:
    """int64 counts of the values of `idx` in [0, size), into a tensor of
    fixed size on idx's device. Unlike `torch.bincount`, this reads nothing
    back to the host, so it does not synchronize a CUDA stream."""
    idx = idx.reshape(-1)
    counts = torch.zeros(size, dtype=torch.int64, device=idx.device)
    return counts.index_add_(0, idx, torch.ones_like(idx))


def confusion_hist(pred: torch.Tensor, label: torch.Tensor,
                   num_classes: int, ignore_label: int = 255) -> torch.Tensor:
    """(n, n) confusion matrix hist[label, pred] over valid pixels
    (metric.py:7-15), int64. pred is clipped to [0, n-1]; invalid pixels
    are counted in one bin past the matrix and dropped."""
    n = num_classes
    label = label.long()
    valid = _valid(label, n, ignore_label)
    p = pred.long().clamp(0, n - 1)
    idx = torch.where(valid, n * label + p, n * n)
    return _bincount(idx, n * n + 1)[:n * n].reshape(n, n)


def hist_stats(pred: torch.Tensor, label: torch.Tensor, num_classes: int,
               ignore_label: int = 255):
    """hist, labeled-pixel count, correct-pixel count (metric.py:7-15)."""
    valid = _valid(label.long(), num_classes, ignore_label)
    hist = confusion_hist(pred, label, num_classes, ignore_label)
    labeled = valid.sum()
    correct = ((pred.long() == label.long()) & valid).sum()
    return hist, labeled, correct


def compute_score(hist, correct: int = None, labeled: int = None):
    """Per-class IoU, mean IoU, freq-weighted IoU, pixel accuracy
    (metric.py:18-26), in numpy on the host. The mean skips classes that
    are never labeled or predicted (nan IoU)."""
    hist = np.asarray(_host(hist), np.float64)
    diag = np.diag(hist)
    denom = hist.sum(1) + hist.sum(0) - diag
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = diag / denom
    mean_iu = float(np.nanmean(iou))
    freq = hist.sum(1) / max(hist.sum(), 1)
    freq_iu = float((freq[freq > 0] * iou[freq > 0]).sum())
    mean_pixel_acc = (float(correct) / max(float(labeled), 1)
                      if correct is not None else float("nan"))
    return iou, mean_iu, freq_iu, mean_pixel_acc


def batch_intersection_union(logits: torch.Tensor, target: torch.Tensor,
                             num_classes: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class intersection and union from (..., C) logits, ignoring
    label < 0 after the reference's +1 shift (seg_metrics.py:53-78:
    predict/target are 1-indexed, label 0 = ignore)."""
    pred = torch.argmax(logits, dim=-1) + 1
    tgt = target.long() + 1
    valid = tgt > 0
    pred = pred * valid
    inter = pred * (pred == tgt)

    def hist1(x):
        return _bincount(x.clamp(0, num_classes), num_classes + 1)[1:]

    area_inter = hist1(inter)
    area_union = hist1(pred) + hist1(tgt) - area_inter
    return area_inter, area_union


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class SegMetrics:
    """Online accumulator mirroring Seg_Metrics (seg_metrics.py:15-51)."""

    num_classes: int = 19

    def __post_init__(self):
        self.reset()

    def reset(self):
        self.total_inter = np.zeros(self.num_classes, np.int64)
        self.total_union = np.zeros(self.num_classes, np.int64)

    def update(self, area_inter, area_union):
        self.total_inter += _host(area_inter).astype(np.int64)
        self.total_union += _host(area_union).astype(np.int64)

    def get_scores(self) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = 1.0 * self.total_inter / (np.spacing(1) + self.total_union)
        return float(np.nanmean(np.where(self.total_union > 0, iou, np.nan)))
