"""The training batches of FasterSeg's loader, worked out again.

A frozen copy of the published augmentation (FasterSeg search/dataloader.py
`TrainPre`, tools/utils/img_utils.py) and of the batch order keyed by
(seed, epoch, step, slot): for each slot, a permutation of the samples by
numpy's Generator((seed, epoch)) picks the sample, and Generator((seed,
epoch, step, slot)) draws, in this order, the mirror (p = 0.5), the scale
from the scale list and the crop origin. The image is resized with cv2's
INTER_LINEAR sampling (computed exactly here, where cv2 rounds through fixed
point), the label with INTER_NEAREST; then /255, mean and std, and a crop
padded with 0 (image) and the ignore label (label).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def _linear_taps(n_in: int, n_out: int, device) -> Tuple:
    src = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) \
        * (n_in / n_out) - 0.5
    lo = torch.floor(src)
    t = src - lo
    lo = lo.long()
    return lo.clamp(0, n_in - 1), (lo + 1).clamp(0, n_in - 1), t


def resize_linear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W, C) uint8 -> (h, w, C) float64, cv2 INTER_LINEAR sampling."""
    y0, y1, ty = _linear_taps(img.shape[0], h, img.device)
    x0, x1, tx = _linear_taps(img.shape[1], w, img.device)
    f = img.double()
    rows = f[y0] * (1 - ty)[:, None, None] + f[y1] * ty[:, None, None]
    return rows[:, x0] * (1 - tx)[None, :, None] + rows[:, x1] * tx[None, :, None]


def resize_nearest(lab: torch.Tensor, h: int, w: int) -> torch.Tensor:
    ys = torch.clamp((torch.arange(h, dtype=torch.float64) * (lab.shape[0] / h)
                      ).long(), max=lab.shape[0] - 1).to(lab.device)
    xs = torch.clamp((torch.arange(w, dtype=torch.float64) * (lab.shape[1] / w)
                      ).long(), max=lab.shape[1] - 1).to(lab.device)
    return lab[ys][:, xs]


def _crop_pad(t: torch.Tensor, y: int, x: int, ch: int, cw: int, value):
    c = t[y:y + ch, x:x + cw]
    ph, pw = ch - c.shape[0], cw - c.shape[1]
    out = torch.full((ch, cw) + tuple(t.shape[2:]), value, dtype=t.dtype,
                     device=t.device)
    top, left = ph // 2, pw // 2
    out[top:top + c.shape[0], left:left + c.shape[1]] = c
    return out


def sample(img: torch.Tensor, lab: torch.Tensor, rng: np.random.Generator,
           hp: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """One augmented sample: (crop_h, crop_w, 3) fp32, (crop_h, crop_w)
    int64."""
    if rng.random() >= 0.5:
        img, lab = torch.flip(img, [1]), torch.flip(lab, [1])
    scales = hp["train_scale_array"]
    s = scales[rng.integers(0, len(scales))]
    h, w = int(img.shape[0] * s), int(img.shape[1] * s)
    f = resize_linear(img, h, w)
    lab = resize_nearest(lab, h, w)
    mean = torch.tensor(hp["image_mean"], dtype=torch.float64, device=f.device)
    std = torch.tensor(hp["image_std"], dtype=torch.float64, device=f.device)
    f = (f / 255.0 - mean) / std
    ch, cw = hp["crop_hw"]
    y = int(rng.integers(0, h - ch + 2)) if h > ch else 0
    x = int(rng.integers(0, w - cw + 2)) if w > cw else 0
    return (_crop_pad(f, y, x, ch, cw, 0.0).float(),
            _crop_pad(lab.long(), y, x, ch, cw, hp["ignore_label"]))


def batch(images: torch.Tensor, labels: torch.Tensor, seed: int, epoch: int,
          step: int, batch_size: int, hp: Dict) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """The batch at (epoch, step) of a shuffled loader over the samples
    images (N, H, W, 3) uint8 and labels (N, H, W)."""
    n = images.shape[0]
    order = np.random.default_rng((seed, epoch)).permutation(n)
    xs, ys = [], []
    for slot in range(batch_size):
        i = int(order[(step * batch_size + slot) % n])
        x, y = sample(images[i], labels[i],
                      np.random.default_rng((seed, epoch, step, slot)), hp)
        xs.append(x)
        ys.append(y)
    return torch.stack(xs), torch.stack(ys)


def level(std: Sequence[float]) -> float:
    """One uint8 level after normalisation, in the channel where it is
    largest."""
    return 1.0 / 255.0 / min(std)
