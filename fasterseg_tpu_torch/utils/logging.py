"""Console/file logging and run directories.

Counterpart of the parts of the JAX package's utils/logging.py that training
needs (the reference's tools/engine/logger.py): a coloured console logger
with a FASTERSEG_LOGGING_LEVEL override and an optional file sink, and
timestamped run directories.
"""

from __future__ import annotations

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
