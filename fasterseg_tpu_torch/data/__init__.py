"""Evaluation data: file-list datasets, the procedural ProcCity scenes and
eval preprocessing (numpy, host side). Imports without cv2."""

from .datasets import (
    Cityscapes,
    BDD,
    CamVid,
    FileListDataset,
    SyntheticDataset,
    DataSetting,
    CITYSCAPES_CLASSES,
    CITYSCAPES_COLORS,
    CITYSCAPES_TRAIN_TO_LABEL_ID,
)
from .preprocess import eval_preprocess, normalize
