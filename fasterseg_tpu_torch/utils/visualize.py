"""Prediction overlays and the per-class IoU report.

A copy of the JAX package's utils/visualize.py (the reference's
tools/utils/visualize.py: show_img / show_prediction colour overlays,
print_iou), numpy only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def set_img_color(img: np.ndarray, label: np.ndarray,
                  colors: Sequence, background: int = -1) -> np.ndarray:
    out = img.copy()
    for i, color in enumerate(colors):
        out[label == i] = color
    out[label == 255] = 0
    return out


def show_prediction(img: np.ndarray, pred: np.ndarray, colors: Sequence,
                    alpha: float = 0.5) -> np.ndarray:
    """Blend a class map over the image (visualize.py:29-41)."""
    colored = set_img_color(np.zeros_like(img), pred, colors)
    return (img * (1 - alpha) + colored * alpha).astype(np.uint8)


def show_img(img: np.ndarray, gt: np.ndarray, pred: np.ndarray,
             colors: Sequence) -> np.ndarray:
    """Side-by-side [image | gt overlay | pred overlay]."""
    return np.concatenate([
        img,
        show_prediction(img, gt, colors),
        show_prediction(img, pred, colors),
    ], axis=1)


def print_iou(iou: np.ndarray, mean_pixel_acc: float = float("nan"),
              class_names: Optional[Sequence[str]] = None,
              show_no_back: bool = False) -> str:
    """Per-class IoU report (visualize.py:61-89)."""
    n = len(iou)
    lines = []
    for i in range(n):
        cls = class_names[i] if class_names else f"Class {i + 1}"
        lines.append(f"{cls:<22} {iou[i] * 100:.3f}%")
    mean_iu = np.nanmean(iou) * 100
    line = f"{'mean_IU':<22} {mean_iu:.3f}%"
    if show_no_back:
        mean_iu_nb = np.nanmean(iou[1:]) * 100
        line += f"  mean_IU_no_back {mean_iu_nb:.3f}%"
    if np.isfinite(mean_pixel_acc):
        line += f"  mean_pixel_acc {mean_pixel_acc * 100:.3f}%"
    lines.append("-" * 45)
    lines.append(line)
    return "\n".join(lines)
