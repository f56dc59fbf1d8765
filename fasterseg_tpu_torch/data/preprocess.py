"""Eval-time preprocessing, numpy on the host.

Counterpart of the eval half of the JAX package's data/preprocess.py (the
reference's tools/utils/img_utils.py): cv2-semantics resizes, normalisation
and centre padding. cv2 is optional: without it `_resize` takes a numpy
fallback with cv2's index maps, which truncates where cv2 rounds (up to one
level on a uint8 image), exactly as the JAX package does on such a host. The
training augmentation (`TrainPre`, `random_*`) comes with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except ImportError:
    cv2 = None
    _HAS_CV2 = False


def _resize(img: np.ndarray, wh: Tuple[int, int], nearest: bool) -> np.ndarray:
    """cv2.resize to (w, h), INTER_NEAREST or INTER_LINEAR."""
    if _HAS_CV2:
        interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
        return cv2.resize(img, wh, interpolation=interp)
    # numpy fallback with cv2-equivalent index maps
    w, h = wh
    ih, iw = img.shape[:2]
    if nearest:
        ys = np.minimum((np.arange(h) * (ih / h)).astype(int), ih - 1)
        xs = np.minimum((np.arange(w) * (iw / w)).astype(int), iw - 1)
        return img[ys][:, xs]
    ys = (np.arange(h) + 0.5) * ih / h - 0.5
    xs = (np.arange(w) + 0.5) * iw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, iw - 1)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    if img.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    a = img[y0][:, x0].astype(np.float64)
    b = img[y0][:, x1].astype(np.float64)
    c = img[y1][:, x0].astype(np.float64)
    d = img[y1][:, x1].astype(np.float64)
    out = a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx \
        + c * wy * (1 - wx) + d * wy * wx
    return out.astype(img.dtype)


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    """img_utils normalize: /255, subtract mean, divide std."""
    img = img.astype(np.float32) / 255.0
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def pad_image_to_shape(img, shape, value):
    """Center-pad to at least `shape` (img_utils.py:60-74); returns the
    padded image and the margins (top, bottom, left, right)."""
    pad_h = max(shape[0] - img.shape[0], 0)
    pad_w = max(shape[1] - img.shape[1], 0)
    margin = (pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2)
    pads = [(margin[0], margin[1]), (margin[2], margin[3])]
    if img.ndim == 3:
        pads.append((0, 0))
    img = np.pad(img, pads, constant_values=value)
    return img, margin


def eval_preprocess(img: np.ndarray, mean, std) -> np.ndarray:
    """Whole-image eval normalization (evaluator.py:320-339): /255,
    mean/std, float32 HWC."""
    return np.ascontiguousarray(normalize(img, mean, std), np.float32)
