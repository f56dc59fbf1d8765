"""Data: file-list datasets, the procedural ProcCity scenes, train and eval
preprocessing and the train loader (numpy, host side). Imports without
cv2."""

from .datasets import (
    Cityscapes,
    BDD,
    CamVid,
    FileListDataset,
    InMemoryDataset,
    SyntheticDataset,
    DataSetting,
    CITYSCAPES_CLASSES,
    CITYSCAPES_COLORS,
    CITYSCAPES_TRAIN_TO_LABEL_ID,
)
from .preprocess import TrainPre, eval_preprocess, normalize
from .loader import TrainLoader, get_train_loader
