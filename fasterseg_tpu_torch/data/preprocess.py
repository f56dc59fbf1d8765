"""Train and eval preprocessing, numpy on the host.

Counterpart of the JAX package's data/preprocess.py (the reference's
tools/utils/img_utils.py and the TrainPre of search/dataloader.py:14-31):
cv2-semantics resizes, normalisation, centre padding, and the training
augmentation

  random mirror (p=0.5) -> random scale from {0.75, 1, 1.25}
  -> normalize (/255, mean/std) -> random crop + pad (img 0, label 255)
  -> label downsample x gt_down_sampling, INTER_NEAREST

Every sample draws from an explicit numpy Generator (seeded per (seed,
epoch, step, slot) by data/loader.py), in the JAX package's draw order, so
both packages augment a sample alike. cv2 is optional: without it `_resize`
takes a numpy fallback with cv2's index maps, which truncates where cv2
rounds (up to one level on a uint8 image), exactly as the JAX package does
on such a host; `TrainPre` prefers the native kernels (data/native.py),
which need no cv2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

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


def random_mirror(rng: np.random.Generator, img, gt):
    """img_utils.py:125-130."""
    if rng.random() >= 0.5:
        img = img[:, ::-1]
        gt = gt[:, ::-1] if gt is not None else None
    return img, gt


def random_scale(rng: np.random.Generator, img, gt,
                 scales: Sequence[float]):
    """img_utils.py:105-112."""
    scale = scales[rng.integers(0, len(scales))]
    sh, sw = int(img.shape[0] * scale), int(img.shape[1] * scale)
    img = _resize(img, (sw, sh), nearest=False)
    if gt is not None:
        gt = _resize(gt, (sw, sh), nearest=True)
    return img, gt, scale


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


def _crop_origin(rng: np.random.Generator, hw, crop_hw) -> Tuple[int, int]:
    """generate_random_crop_pos (img_utils.py:24-34)."""
    (h, w), (ch, cw) = hw, crop_hw
    pos_h = int(rng.integers(0, h - ch + 2)) if h > ch else 0
    pos_w = int(rng.integers(0, w - cw + 2)) if w > cw else 0
    return pos_h, pos_w


def random_crop_pad(rng: np.random.Generator, img, gt,
                    crop_hw: Tuple[int, int],
                    img_pad: float = 0.0, label_pad: int = 255):
    """generate_random_crop_pos + random_crop_pad_to_shape
    (img_utils.py:24-57)."""
    ch, cw = crop_hw
    pos_h, pos_w = _crop_origin(rng, img.shape[:2], crop_hw)
    img_c = img[pos_h:pos_h + ch, pos_w:pos_w + cw]
    img_c, _ = pad_image_to_shape(img_c, crop_hw, img_pad)
    gt_c = None
    if gt is not None:
        gt_c = gt[pos_h:pos_h + ch, pos_w:pos_w + cw]
        gt_c, _ = pad_image_to_shape(gt_c, crop_hw, label_pad)
    return img_c, gt_c


@dataclasses.dataclass
class TrainPre:
    """The augmentation chain (search/dataloader.py:14-31): (rng, uint8 HWC
    image, HW label) -> (float32 (ch, cw, 3), int32 label map).

    uint8 images go through the native kernels (data/native.py) where they
    build; the numpy/cv2 path is the semantics reference and draws from the
    rng in the same order, so both give the same sample (up to the numpy
    resize fallback's rounding on a host without cv2)."""

    image_mean: Sequence[float]
    image_std: Sequence[float]
    crop_hw: Tuple[int, int]
    train_scale_array: Optional[Sequence[float]] = (0.75, 1.0, 1.25)
    gt_down_sampling: int = 1
    ignore_label: int = 255
    use_native: bool = True

    def uses_native(self) -> bool:
        """Whether uint8 samples take the native kernels."""
        from . import native
        return self.use_native and native.available()

    def __call__(self, rng: np.random.Generator, img: np.ndarray,
                 gt: Optional[np.ndarray]):
        if img.dtype == np.uint8 and self.uses_native():
            return self._call_native(rng, img, gt)
        return self._call_numpy(rng, img, gt)

    def _call_numpy(self, rng, img, gt):
        img, gt = random_mirror(rng, img, gt)
        if self.train_scale_array is not None:
            img, gt, _ = random_scale(rng, img, gt, self.train_scale_array)
        img = normalize(img, self.image_mean, self.image_std)
        img, gt = random_crop_pad(rng, img, gt, self.crop_hw,
                                  img_pad=0.0, label_pad=self.ignore_label)
        if gt is not None and self.gt_down_sampling > 1:
            d = self.gt_down_sampling
            gt = _resize(gt, (self.crop_hw[1] // d, self.crop_hw[0] // d),
                         nearest=True)
        img = np.ascontiguousarray(img, np.float32)
        gt = (np.ascontiguousarray(gt, np.int32)
              if gt is not None else None)
        return img, gt

    def _call_native(self, rng, img, gt):
        from . import native
        # the numpy path's draw order: mirror, scale, crop origin
        if rng.random() >= 0.5:
            img = native.mirror_u8(img)
            gt = gt[:, ::-1] if gt is not None else None
        if self.train_scale_array is not None:
            scale = self.train_scale_array[
                rng.integers(0, len(self.train_scale_array))]
            sh, sw = int(img.shape[0] * scale), int(img.shape[1] * scale)
            img = native.resize_bilinear_u8(img, sh, sw)
            if gt is not None:
                gt = native.resize_nearest_u8(gt, sh, sw)
        ch, cw = self.crop_hw
        pos_h, pos_w = _crop_origin(rng, img.shape[:2], self.crop_hw)
        out = native.crop_pad_normalize(img, pos_h, pos_w, ch, cw,
                                        self.image_mean, self.image_std)
        gt_out = None
        if gt is not None:
            gt_out = native.crop_pad_u8(gt, pos_h, pos_w, ch, cw,
                                        pad=self.ignore_label)
            if self.gt_down_sampling > 1:
                d = self.gt_down_sampling
                gt_out = native.resize_nearest_u8(gt_out, ch // d, cw // d)
            gt_out = gt_out.astype(np.int32)
        return out, gt_out


def eval_preprocess(img: np.ndarray, mean, std) -> np.ndarray:
    """Whole-image eval normalization (evaluator.py:320-339): /255,
    mean/std, float32 HWC."""
    return np.ascontiguousarray(normalize(img, mean, std), np.float32)
