"""ProcCity: a procedurally generated street-scene segmentation benchmark.

Cityscapes is not redistributable, so accuracy studies in this repo run on
a deterministic procedural dataset with Cityscapes-like structure: sky /
building / vegetation / road / sidewalk layers plus car / person / pole
foreground objects, rendered to real PNGs with per-instance color jitter,
global illumination changes, and sensor noise. Scenes are a pure function
of (seed, index), so the dataset is reproducible bit-for-bit anywhere.

A copy of the JAX package's data/procgen.py: the same (seed, index) renders
the same scene, bit for bit, in both packages. `write_dataset` writes the
on-disk layout the file-list datasets and the reference consume
(tools/datasets/BaseDataset.py:39-44: "img gt" file lists resolved against
img/gt roots); it needs cv2 and raises without it.

Classes (8, a subset of the Cityscapes schema with the same semantics):
  0 road, 1 sidewalk, 2 building, 3 pole, 4 vegetation, 5 sky,
  6 person, 7 car.  Boundary pixels get ignore_label 255.

Segmentation is learnable but not trivial: class colors overlap (gray
buildings vs gray sidewalks vs dark road), objects occlude the layers,
and illumination is global per-image, so a net must use texture + shape +
context, not a per-pixel color table.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

PROCCITY_CLASSES = ("road", "sidewalk", "building", "pole", "vegetation",
                    "sky", "person", "car")
NUM_CLASSES = len(PROCCITY_CLASSES)
IGNORE = 255

# base palette (RGB) — deliberately overlapping grays/greens
_BASE = np.array([
    (90, 90, 95),     # road: dark gray asphalt
    (150, 145, 140),  # sidewalk: light gray pavement
    (120, 115, 110),  # building: mid gray facade
    (140, 140, 140),  # pole: gray
    (70, 110, 60),    # vegetation: green
    (135, 170, 210),  # sky: blue-gray
    (180, 90, 70),    # person: red-brown
    (60, 70, 120),    # car: blue-gray body
], np.float32)


def _noise(rng, hw, scale):
    """Smooth multiplicative texture field in [1-scale, 1+scale]."""
    h, w = hw
    coarse = rng.random((max(2, h // 16), max(2, w // 16))).astype(np.float32)
    ys = np.linspace(0, coarse.shape[0] - 1, h)
    xs = np.linspace(0, coarse.shape[1] - 1, w)
    yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
    yf, xf = (ys - yi)[:, None], (xs - xi)[None, :]
    yi2 = np.minimum(yi + 1, coarse.shape[0] - 1)
    xi2 = np.minimum(xi + 1, coarse.shape[1] - 1)
    a = coarse[yi][:, xi] * (1 - yf) * (1 - xf)
    b = coarse[yi][:, xi2] * (1 - yf) * xf
    c = coarse[yi2][:, xi] * yf * (1 - xf)
    d = coarse[yi2][:, xi2] * yf * xf
    return 1.0 + (a + b + c + d - 0.5) * 2 * scale


def render_scene(seed: int, index: int,
                 hw: Tuple[int, int] = (256, 512)):
    """Render one scene; returns (image uint8 HxWx3 RGB, label uint8 HxW)."""
    h, w = hw
    rng = np.random.default_rng((seed, index))
    label = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]

    # --- layered background ---------------------------------------
    horizon = int(h * rng.uniform(0.35, 0.5))
    road_top = int(h * rng.uniform(0.62, 0.72))
    side_top = int(h * rng.uniform(0.55, 0.62))

    label[:] = 5                                   # sky
    # building skyline: piecewise-constant rooftop heights
    n_bld = rng.integers(3, 7)
    edges = np.sort(rng.integers(0, w, n_bld - 1))
    edges = np.concatenate([[0], edges, [w]])
    for i in range(len(edges) - 1):
        top = int(horizon * rng.uniform(0.3, 1.0))
        label[top:side_top, edges[i]:edges[i + 1]] = 2   # building
    # vegetation blobs at the building/sidewalk boundary
    for _ in range(rng.integers(2, 6)):
        cx, cy = rng.integers(0, w), rng.integers(int(h * 0.35), side_top)
        rx, ry = rng.integers(w // 20, w // 6), rng.integers(h // 16, h // 6)
        blob = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1.0
        label[blob] = 4                            # vegetation
    label[side_top:road_top] = 1                   # sidewalk band
    label[road_top:] = 0                           # road

    # --- foreground objects (occlude background) -------------------
    # poles: thin vertical bars rising from the sidewalk
    for _ in range(rng.integers(1, 4)):
        px = rng.integers(0, w - 3)
        ptop = rng.integers(int(h * 0.2), side_top)
        pw = rng.integers(2, 4)
        label[ptop:road_top, px:px + pw] = 3       # pole
    # persons: capsules on the sidewalk
    for _ in range(rng.integers(0, 4)):
        cx = rng.integers(5, w - 5)
        foot = rng.integers(side_top + 2, road_top + 5)
        ph = rng.integers(h // 10, h // 5)
        pw = max(3, ph // 3)
        body = (np.abs(xx - cx) < pw // 2) & (yy > foot - ph) & (yy < foot)
        head = ((xx - cx) ** 2 + (yy - (foot - ph)) ** 2) < (pw // 2 + 1) ** 2
        label[body | head] = 6                     # person
    # cars: rounded boxes on the road
    for _ in range(rng.integers(1, 4)):
        cw = rng.integers(w // 8, w // 4)
        ch = max(6, cw // 3)
        cx = rng.integers(0, max(1, w - cw))
        cy = rng.integers(road_top - ch // 3, h - ch)
        body = (xx >= cx) & (xx < cx + cw) & (yy >= cy) & (yy < cy + ch)
        cabin = ((xx >= cx + cw // 5) & (xx < cx + cw - cw // 5)
                 & (yy >= cy - ch // 2) & (yy < cy))
        label[body | cabin] = 7                    # car

    # --- shading ----------------------------------------------------
    img = _BASE[np.minimum(label, NUM_CLASSES - 1)].copy()
    # per-image global illumination + per-class jitter (breaks a fixed
    # color->class mapping across the dataset)
    gain = rng.uniform(0.7, 1.3)
    jitter = rng.normal(0, 14, (NUM_CLASSES, 3)).astype(np.float32)
    img += jitter[np.minimum(label, NUM_CLASSES - 1)]
    img *= gain
    # textures: road speckle, facade stripes, vegetation clumps
    img *= _noise(rng, (h, w), 0.18)[..., None]
    stripe = (1 + 0.12 * np.sin(xx * rng.uniform(0.3, 0.9))).astype(np.float32)
    img[label == 2] *= stripe[label == 2, None]
    # sky vertical gradient
    grad = (1 + 0.25 * (1 - yy / max(1, h))).astype(np.float32)
    img[label == 5] *= grad[label == 5, None]
    # sensor noise
    img += rng.normal(0, 6, img.shape).astype(np.float32)
    img = np.clip(img, 0, 255).astype(np.uint8)

    # --- ignore boundaries (1px dilated class edges) ----------------
    lab = label.astype(np.int16)
    edge = np.zeros((h, w), bool)
    edge[:, 1:] |= lab[:, 1:] != lab[:, :-1]
    edge[1:, :] |= lab[1:, :] != lab[:-1, :]
    out = label.copy()
    out[edge] = IGNORE
    return img, out


class ProcCity:
    """In-memory ProcCity dataset with the sample-dict interface
    (usable directly by the Evaluator without touching disk)."""

    num_classes = NUM_CLASSES
    ignore_label = IGNORE
    class_names = PROCCITY_CLASSES

    def __init__(self, length: int = 128, hw: Tuple[int, int] = (256, 512),
                 seed: int = 0, split: str = "train",
                 portion: Optional[float] = None, file_length=None):
        # different splits draw from disjoint index ranges
        base = {"train": 0, "val": 1 << 20, "test": 2 << 20}[split]
        self.base = base
        if portion is not None:
            n = length
            length = (int(np.floor(n * portion)) if portion >= 0
                      else n - int(np.floor(n * (1 + portion))))
        self.length = file_length or length
        self.real_length = length
        self.hw = hw
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        i = idx % self.real_length
        img, label = render_scene(self.seed, self.base + i, self.hw)
        return {"data": img, "label": label, "fn": f"proccity_{i}",
                "n": self.real_length}


def make_dataset_cls():
    """A FileListDataset subclass bound to the ProcCity schema, for
    feeding materialized ProcCity through the standard file-list path."""
    from .datasets import FileListDataset

    class ProcCityFiles(FileListDataset):
        num_classes = NUM_CLASSES
        ignore_label = IGNORE
        class_names = PROCCITY_CLASSES

    return ProcCityFiles


def write_dataset(root: str, n_train: int = 160, n_val: int = 40,
                  hw: Tuple[int, int] = (256, 512), seed: int = 0):
    """Materialize ProcCity as PNGs + file lists in the shared layout:

        root/leftImg8bit/{train,val}/*.png
        root/gtFine/{train,val}/*.png
        root/{train,val}.txt          ("img gt" lines)

    Consumable by FileListDataset and by the reference's BaseDataset (same
    file-list convention). Needs cv2 to write the PNGs.
    """
    try:
        import cv2
    except ImportError as e:
        raise ImportError("write_dataset needs cv2 (OpenCV) to write PNGs, "
                          "which is not installed on this host") from e
    counts = {"train": n_train, "val": n_val}
    for split, n in counts.items():
        img_dir = os.path.join(root, "leftImg8bit", split)
        gt_dir = os.path.join(root, "gtFine", split)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        ds = ProcCity(length=n, hw=hw, seed=seed, split=split)
        lines = []
        for i in range(n):
            s = ds[i]
            name = f"proccity_{split}_{i:04d}.png"
            # imwrite expects BGR; store RGB flipped so imread(BGR)[::-1]
            # round-trips to the rendered RGB exactly
            cv2.imwrite(os.path.join(img_dir, name), s["data"][..., ::-1])
            cv2.imwrite(os.path.join(gt_dir, name.replace(".png", "_gt.png")),
                        s["label"])
            lines.append(f"leftImg8bit/{split}/{name} "
                         f"gtFine/{split}/{name.replace('.png', '_gt.png')}")
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root
