"""Typed configuration — one schema, per-workload presets.

Replaces the reference's three duplicated easydict config modules
(`search/config_search.py`, `train/config_train.py`, `latency/config.py`)
with frozen dataclasses. Every constant mirrors a reference value (cited);
presets cover the four workloads: supernet pretrain, architecture search,
teacher/student training, and latency measurement.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

WIDTH_MULT_LIST = (4.0 / 12, 6.0 / 12, 8.0 / 12, 10.0 / 12, 1.0)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset + preprocessing (reference config_search.py:40-63)."""

    dataset: str = "cityscapes"
    dataset_path: str = "data/cityscapes"
    train_source: str = "cityscapes_train_fine.txt"
    train_eval_source: str = "cityscapes_train_val_fine.txt"
    eval_source: str = "cityscapes_val_fine.txt"
    test_source: str = "cityscapes_test.txt"
    num_classes: int = 19
    ignore_label: int = 255
    # ImageNet normalization (config_search.py:49-50)
    image_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    num_train_imgs: int = 2975
    num_eval_imgs: int = 500
    # integer downsampling applied on load (BaseDataset.py:128-148)
    down_sampling: int = 1
    # label downsample factor inside the train pipeline (search: 8; train: 1)
    gt_down_sampling: int = 1
    train_scale_array: Tuple[float, ...] = (0.75, 1.0, 1.25)
    image_height: int = 512
    image_width: int = 1024
    batch_size: int = 12
    num_workers: int = 4
    synthetic: bool = False          # synthetic data for tests/smoke runs
    synthetic_length: int = 64


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Whole-image eval protocol (config_train.py:66-72)."""

    eval_height: int = 1024
    eval_width: int = 2048
    eval_scale_array: Tuple[float, ...] = (1.0,)
    eval_flip: bool = False
    eval_stride_rate: float = 5.0 / 6
    eval_crop_size: int = 1024


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Supernet pretrain + architecture search (config_search.py:66-107)."""

    data: DataConfig = DataConfig(
        gt_down_sampling=8, down_sampling=2,
        image_height=224, image_width=448, batch_size=2)
    eval: EvalConfig = EvalConfig(eval_height=512, eval_width=1024)
    seed: int = 12345
    layers: int = 16
    Fch: int = 12
    width_mult_list: Tuple[float, ...] = WIDTH_MULT_LIST
    prun_modes: Tuple[str, ...] = ("max", "arch_ratio")
    stem_head_width: Tuple[Tuple[float, float], ...] = (
        (1.0, 1.0), (8.0 / 12, 8.0 / 12))
    pretrain: bool = False
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1
    # weight optimizer (train_search.py:83-101)
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lr_decay: float = 0.978          # ExponentialLR gamma per epoch
    grad_clip: float = 5.0
    # rematerialize the cell grid in the multi-forward search loss
    supernet_remat: bool = True
    # supernet compute dtype ("float32" | "bfloat16"); params stay f32
    compute_dtype: str = "float32"
    nepochs: int = 30
    # arch optimizer (architect.py:22-24)
    arch_learning_rate: float = 3e-4
    arch_weight_decay: float = 0.0
    # latency regularization (config_search.py:85-99, architect.py:62-74)
    latency_weight: Tuple[float, ...] = (0.0, 1e-2)
    # per-arch FPS band [teacher, student] (config_search.py:85-86)
    fps_min: Tuple[float, ...] = (0.0, 155.0)
    fps_max: Tuple[float, ...] = (0.0, 175.0)
    # weighting of alpha/beta/ratio latency terms (architect.py:69-72)
    lat_split: Tuple[float, float, float] = (1.0 / 500, 497.0 / 500, 2.0 / 500)
    train_portion: float = 0.5
    unrolled: bool = False
    pretrain_epochs: int = 20
    pretrain_image_hw: Tuple[int, int] = (256, 512)
    pretrain_batch_size: int = 3
    num_classes: int = 19
    save: str = "runs/search"
    load_path: Optional[str] = None
    # latency estimation input (architect.py:66)
    latency_input_hw: Tuple[int, int] = (1024, 2048)

    def niters_per_epoch(self, pretrain: bool) -> int:
        bs = self.pretrain_batch_size if pretrain else self.data.batch_size
        imgs = self.data.num_train_imgs
        if not pretrain:
            imgs = int(imgs * self.train_portion)
        return max(1, imgs // bs)

    def min_kept(self, pretrain: bool) -> int:
        h, w = ((self.pretrain_image_hw if pretrain
                 else (self.data.image_height, self.data.image_width)))
        bs = self.pretrain_batch_size if pretrain else self.data.batch_size
        # train_search.py:62-63
        return int(bs * h * w // (16 * self.data.gt_down_sampling ** 2))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Train-from-scratch teacher/student (config_train.py:56-109)."""

    data: DataConfig = DataConfig()
    eval: EvalConfig = EvalConfig()
    seed: int = 12345
    mode: str = "student"            # "teacher" | "student"
    arch_idx: Tuple[int, ...] = (0, 1)
    layers: int = 16
    Fch: int = 12
    width_mult_list: Tuple[float, ...] = WIDTH_MULT_LIST
    stem_head_width: Tuple[Tuple[float, float], ...] = (
        (1.0, 1.0), (8.0 / 12, 8.0 / 12))
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lr_decay: float = 0.992          # per-epoch multiplicative decay (train.py:37-39)
    nepochs: int = 600
    niters_per_epoch: int = 1000
    # aux head weights + distillation (train.py:256-260)
    aux_weight: float = 0.2
    load_path: str = "fasterseg"
    teacher_path: str = "fasterseg"
    load_epoch: str = "last"
    is_test: bool = False
    is_eval: bool = False
    eval_path: str = "fasterseg"
    save: str = "runs/train"
    eval_every: int = 10             # validation cadence in epochs (train.py:197)

    def min_kept(self) -> int:
        d = self.data
        return int(d.batch_size * d.image_height * d.image_width
                   // (16 * d.gt_down_sampling ** 2))


@dataclasses.dataclass(frozen=True)
class LatencyConfig:
    """End-to-end latency measurement (latency/config.py:30-58)."""

    mode: str = "student"
    layers: int = 16
    Fch: int = 12
    width_mult_list: Tuple[float, ...] = WIDTH_MULT_LIST
    stem_head_width: Tuple[Tuple[float, float], ...] = (
        (1.0, 1.0), (8.0 / 12, 8.0 / 12))
    num_classes: int = 19
    eval_height: int = 1024
    eval_width: int = 2048
    load_path: str = "fasterseg"
    lut_path: str = "latency_lut.json"
    dtype: str = "bfloat16"
    warmup_iters: int = 10
    min_measure_seconds: float = 0.5


def cityscapes_search_config(**overrides) -> SearchConfig:
    return dataclasses.replace(SearchConfig(), **overrides)


def cityscapes_pretrain_config(**overrides) -> SearchConfig:
    return dataclasses.replace(SearchConfig(pretrain=True), **overrides)


def cityscapes_teacher_config(**overrides) -> TrainConfig:
    cfg = TrainConfig(mode="teacher", arch_idx=(0,),
                      stem_head_width=((1.0, 1.0),))
    return dataclasses.replace(cfg, **overrides)


def cityscapes_student_config(**overrides) -> TrainConfig:
    return dataclasses.replace(TrainConfig(), **overrides)
