"""Console/file logging, scalar metrics and run directories.

Counterpart of the JAX package's utils/logging.py (the reference's
tools/engine/logger.py and its tensorboardX SummaryWriter): a coloured
console logger with a FASTERSEG_LOGGING_LEVEL override and an optional file
sink, a metric writer (scalars, figures, images), and timestamped run
directories.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time
from typing import Optional

_COLORS = {"WARNING": 33, "INFO": 36, "DEBUG": 37, "CRITICAL": 35,
           "ERROR": 31}


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stdout.isatty() and record.levelname in _COLORS:
            return f"\x1b[{_COLORS[record.levelname]}m{msg}\x1b[0m"
        return msg


def get_logger(name: str = "fasterseg_tpu_torch",
               log_file: Optional[str] = None,
               level: Optional[str] = None) -> logging.Logger:
    """Coloured console logger, configured once per name; `log_file` adds
    a file sink; the level comes from FASTERSEG_LOGGING_LEVEL (default
    INFO)."""
    logger = logging.getLogger(name)
    if not getattr(logger, "_fasterseg_configured", False):
        level = level or os.environ.get("FASTERSEG_LOGGING_LEVEL", "INFO")
        logger.setLevel(getattr(logging, level.upper(), logging.INFO))
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(_ColorFormatter(
            "%(asctime)s %(levelname)s %(message)s", datefmt="%m/%d %H:%M:%S"))
        logger.addHandler(h)
        logger._fasterseg_configured = True
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(fh)
    return logger


class MetricWriter:
    """`add_scalar`, `add_figure` and `add_image` as SummaryWriter's. Every
    scalar goes to `log_dir/metrics.jsonl` (one JSON object a line: tag,
    value, step, time), every figure to a PNG in `log_dir`; both go to
    TensorBoard too where `torch.utils.tensorboard` imports, and images go
    only there."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "time": time.time()}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_figure(self, tag: str, figure, step: int) -> None:
        """A matplotlib figure as `log_dir/<tag, / as _>_<step>.png`."""
        path = os.path.join(self.log_dir,
                            f"{tag.replace('/', '_')}_{step}.png")
        figure.savefig(path, bbox_inches="tight")
        if self._tb is not None:
            self._tb.add_figure(tag, figure, step)

    def add_image(self, tag: str, image_hwc, step: int) -> None:
        """An HWC image array, to TensorBoard only (as CHW)."""
        if self._tb is not None:
            import numpy as np
            self._tb.add_image(tag, np.transpose(image_hwc, (2, 0, 1)), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def create_exp_dir(base: str, name: Optional[str] = None) -> str:
    """A timestamped run directory under `base`, with the git revision of
    the code in GIT_REVISION where git can tell it."""
    run = f"{name or 'run'}-{time.strftime('%Y%m%d-%H%M%S')}"
    path = os.path.join(base, run)
    os.makedirs(path, exist_ok=True)
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=30,
                             cwd=os.path.dirname(os.path.abspath(__file__))
                             ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        rev = ""
    if rev:
        with open(os.path.join(path, "GIT_REVISION"), "w") as f:
            f.write(rev + "\n")
    return path
