"""File-list segmentation datasets.

Counterpart of the JAX package's data/datasets.py (the reference's
tools/datasets/BaseDataset.py and its cityscapes/bdd/camvid classes): a
dataset is a text file of "img_path gt_path" lines resolved against image
and label roots. Replicated behaviours:

* integer down-sampling on load (BaseDataset.py:128-148)
* `portion` split: positive keeps the head fraction, negative the tail
  (BaseDataset.py:86-93)
* `index_select` explicit reordering (BaseDataset.py:83-85)
* oversampling to a fixed epoch length (BaseDataset.py:102-112)
* BGR -> RGB after cv2 load (BaseDataset.py:44)

Reading PNGs needs cv2 (OpenCV). The module imports without it; a file-list
dataset then raises when it is asked for an image. `SyntheticDataset`,
`InMemoryDataset` and `procgen.ProcCity` need no files.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
    cv2.setNumThreads(0)  # avoid worker thread contention (dataloader.py:1-2)
    _HAS_CV2 = True
except ImportError:
    cv2 = None
    _HAS_CV2 = False


# Cityscapes 19-class metadata (tools/datasets/cityscapes/cityscapes.py:7-41,
# train/test.py:25-46). Public dataset constants.
CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle")
CITYSCAPES_TRAIN_TO_LABEL_ID = (
    7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31,
    32, 33)
CITYSCAPES_COLORS = (
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
    (0, 0, 230), (119, 11, 32))

BDD_CLASSES = CITYSCAPES_CLASSES  # BDD uses the 19-class Cityscapes schema
# CamVid 11-class schema (tools/datasets/camvid/camvid.py)
CAMVID_CLASSES = (
    "Building", "Tree", "Sky", "Car", "Sign-Symbol", "Road",
    "Pedestrian", "Fence", "Column-Pole", "Side-Walk", "Bicyclist")
CAMVID_COLORS = (
    (128, 0, 0), (128, 128, 0), (128, 128, 128), (64, 0, 128),
    (192, 128, 128), (128, 64, 128), (64, 64, 0), (64, 64, 128),
    (192, 192, 128), (0, 0, 192), (0, 128, 192))


# Canonical Cityscapes index files shipped as package data: the standard
# sorted enumeration of the public dataset, as the reference ships them
# under tools/datasets/cityscapes/.
LISTS_DIR = os.path.join(os.path.dirname(__file__), "lists")


def resolve_source(source: Optional[str]) -> Optional[str]:
    """Resolve a file-list path: use it if it exists, otherwise fall back
    to the shipped package list of the same name, with a warning (a typoed
    data root would otherwise pair the canonical enumeration with the wrong
    image root and fail later with confusing missing-file errors)."""
    if source and not os.path.isfile(source):
        cand = os.path.join(LISTS_DIR, os.path.basename(source))
        if os.path.isfile(cand):
            logging.getLogger("fasterseg_tpu_torch.data").warning(
                "file list %s does not exist; substituting the shipped "
                "package list %s", source, cand)
            return cand
    return source


@dataclasses.dataclass
class DataSetting:
    img_root: str
    gt_root: str
    train_source: str
    eval_source: str
    test_source: Optional[str] = None
    down_sampling: int = 1


def _require_cv2(path: str) -> None:
    if not _HAS_CV2:
        raise ImportError(f"reading {path} needs cv2 (OpenCV), which is not "
                          f"installed on this host")


def select(items: Sequence, index_select: Optional[Sequence[int]] = None,
           portion: Optional[float] = None) -> list:
    """`items` reordered by `index_select`, then cut to the head (`portion`
    >= 0) or tail (< 0) fraction (BaseDataset.py:83-93)."""
    items = list(items)
    if index_select is not None:
        items = [items[i] for i in index_select]
    if portion is not None:
        n = len(items)
        if portion >= 0:
            items = items[:int(np.floor(n * portion))]
        else:
            items = items[int(np.floor(n * (1 + portion))):]
    return items


class FileListDataset:
    """Base file-list dataset producing dict samples
    {'data': HxWx3 uint8 RGB, 'label': HxW uint8, 'fn': str, 'n': int}."""

    num_classes = 19
    ignore_label = 255

    def __init__(self, setting: DataSetting, split: str = "train",
                 portion: Optional[float] = None,
                 index_select: Optional[Sequence[int]] = None,
                 file_length: Optional[int] = None):
        self.setting = setting
        self.split = split
        source = (setting.train_source if split in ("train", "trainval")
                  else setting.eval_source if split == "val"
                  else setting.test_source)
        self.pairs = select(self._parse(resolve_source(source)),
                            index_select, portion)
        self.file_length = file_length

    @staticmethod
    def _parse(source: str) -> List[Tuple[str, Optional[str]]]:
        pairs = []
        with open(source) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                img = parts[0]
                gt = parts[1] if len(parts) > 1 else None
                pairs.append((img, gt))
        return pairs

    def __len__(self) -> int:
        return self.file_length or len(self.pairs)

    def _real_index(self, idx: int) -> int:
        # oversample by tiling when file_length > len(pairs)
        # (BaseDataset.py:102-112)
        return idx % len(self.pairs)

    def _load_image(self, path: str, down: int) -> np.ndarray:
        _require_cv2(path)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        img = img[..., ::-1]  # BGR -> RGB
        if down > 1:
            img = cv2.resize(img, (img.shape[1] // down,
                                   img.shape[0] // down),
                             interpolation=cv2.INTER_LINEAR)
        return img

    def _load_label(self, path: str, down: int) -> np.ndarray:
        _require_cv2(path)
        gt = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if gt is None:
            raise FileNotFoundError(path)
        if down > 1:
            gt = cv2.resize(gt, (gt.shape[1] // down, gt.shape[0] // down),
                            interpolation=cv2.INTER_NEAREST)
        return gt

    def __getitem__(self, idx: int) -> Dict:
        i = self._real_index(idx)
        img_rel, gt_rel = self.pairs[i]
        img = self._load_image(os.path.join(self.setting.img_root, img_rel),
                               self.setting.down_sampling)
        label = None
        if gt_rel is not None:
            label = self._load_label(
                os.path.join(self.setting.gt_root, gt_rel),
                self.setting.down_sampling)
        return {"data": img, "label": label, "fn": img_rel, "n": len(self.pairs)}


class Cityscapes(FileListDataset):
    num_classes = 19
    class_names = CITYSCAPES_CLASSES
    colors = CITYSCAPES_COLORS
    trans_labels = CITYSCAPES_TRAIN_TO_LABEL_ID

    @staticmethod
    def train_id_to_label_id(pred: np.ndarray) -> np.ndarray:
        """trainId -> official labelId for test-server submission
        (train/test.py:60-69)."""
        out = np.zeros_like(pred, dtype=np.uint8)
        for train_id, label_id in enumerate(CITYSCAPES_TRAIN_TO_LABEL_ID):
            out[pred == train_id] = label_id
        return out


class BDD(FileListDataset):
    num_classes = 19
    class_names = BDD_CLASSES
    colors = CITYSCAPES_COLORS


class CamVid(FileListDataset):
    num_classes = 11
    class_names = CAMVID_CLASSES
    colors = CAMVID_COLORS
    ignore_label = 11


class InMemoryDataset:
    """Samples already in memory (dicts with 'data' and 'label', e.g.
    rendered `procgen.ProcCity` scenes) in a file-list dataset's place: the
    same `index_select` and `portion` selection and oversampling, so a
    loader over it makes the batches it makes over the same samples written
    as PNGs and read back. `InMemoryDataset.bind(samples)` is a
    `dataset_cls` for `get_train_loader` and `search.run_search`."""

    def __init__(self, samples: Sequence[Dict],
                 portion: Optional[float] = None,
                 index_select: Optional[Sequence[int]] = None,
                 file_length: Optional[int] = None):
        self.samples = select(samples, index_select, portion)
        self.file_length = file_length

    @classmethod
    def bind(cls, samples: Sequence[Dict]):
        """A callable with a file-list dataset class's signature that
        serves `samples` whatever the setting and split."""
        def dataset_cls(setting=None, split: str = "train",
                        portion: Optional[float] = None,
                        index_select: Optional[Sequence[int]] = None,
                        file_length: Optional[int] = None):
            return cls(samples, portion, index_select, file_length)
        return dataset_cls

    def __len__(self) -> int:
        return self.file_length or len(self.samples)

    def __getitem__(self, idx: int) -> Dict:
        return self.samples[idx % len(self.samples)]


class SyntheticDataset:
    """Deterministic random images/labels; same sample dict interface."""

    num_classes = 19
    ignore_label = 255

    def __init__(self, length: int = 64, hw: Tuple[int, int] = (128, 256),
                 num_classes: int = 19, seed: int = 0,
                 portion: Optional[float] = None, file_length=None):
        if portion is not None:
            n = length
            length = (int(np.floor(n * portion)) if portion >= 0
                      else n - int(np.floor(n * (1 + portion))))
        self.length = file_length or length
        self.hw = hw
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.default_rng((self.seed, idx))
        h, w = self.hw
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        label = rng.integers(0, self.num_classes, (h, w)).astype(np.uint8)
        label[rng.random((h, w)) < 0.05] = self.ignore_label
        return {"data": img, "label": label, "fn": f"synthetic_{idx}",
                "n": self.length}
