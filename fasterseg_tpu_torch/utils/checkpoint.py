"""Checkpoints: weights, full training state, arch params.

Counterpart of the JAX package's utils/checkpoint.py with its semantics,
not its format: a checkpoint is one `torch.save` file of a plain dict
(state_dicts, the optimizer's state_dict, counters), written with every
tensor on the CPU. Partial-match loading keeps only key-and-shape matches
and reports the three lists the reference warns about (pyt_utils.py:40-77):
entries of the target the checkpoint lacks, entries of the checkpoint the
target lacks, and shape mismatches.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

logger = logging.getLogger("fasterseg_tpu_torch")


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save(path: str, obj: Dict) -> None:
    """Write `obj` (a dict of tensors, state_dicts, numbers) to `path`,
    through a temporary file and a rename, so a run killed mid-write leaves
    the previous checkpoint whole."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_cpu(obj), tmp)
    os.replace(tmp, path)


def load(path: str) -> Dict:
    """A checkpoint written by `save`, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


@dataclasses.dataclass
class PartialLoad:
    """The merged state_dict and what did not match."""

    state: Dict[str, torch.Tensor]
    missing: List[str]       # in the target, not in the checkpoint
    unexpected: List[str]    # in the checkpoint, not used (see mismatched)
    mismatched: List[str]    # in both, at other shapes (target kept)


def partial_load(target: Mapping[str, torch.Tensor],
                 loaded: Mapping[str, Any]) -> PartialLoad:
    """Merge `loaded` into `target` (flat state_dicts), keeping only
    key-and-shape matches; the target's own tensor stays elsewhere. Logs a
    warning for each non-empty list."""
    state, missing, mismatched = {}, [], []
    for k, v in target.items():
        if k not in loaded:
            missing.append(k)
            state[k] = v
        elif tuple(np.shape(loaded[k])) != tuple(v.shape):
            mismatched.append(k)
            state[k] = v
        else:
            state[k] = torch.as_tensor(loaded[k])
    unexpected = [k for k in loaded
                  if k not in target or k in mismatched]
    if missing:
        logger.warning("partial_load: %d params not in checkpoint (e.g. %s)",
                       len(missing), missing[:3])
    if unexpected:
        logger.warning("partial_load: %d checkpoint entries unused (e.g. %s)",
                       len(unexpected), unexpected[:3])
    if mismatched:
        logger.warning("partial_load: %d shape mismatches skipped (e.g. %s)",
                       len(mismatched), mismatched[:3])
    return PartialLoad(state, missing, unexpected, mismatched)


def save_arch(path: str, arch, mIoU02: Optional[float] = None,
              latency02: Optional[float] = None,
              mIoU12: Optional[float] = None,
              latency12: Optional[float] = None) -> None:
    """Arch-params artifact, reference-shaped (train_search.py:186-202):
    alpha/beta/ratio tensors and the search-time branch metrics, as npz."""
    payload = {
        "alpha0": np.asarray(arch.alphas[0]),
        "alpha1": np.asarray(arch.alphas[1]),
        "alpha2": np.asarray(arch.alphas[2]),
        "beta1": np.asarray(arch.betas[1]),
        "beta2": np.asarray(arch.betas[2]),
        "ratio0": np.asarray(arch.ratios[0]),
        "ratio1": np.asarray(arch.ratios[1]),
        "ratio2": np.asarray(arch.ratios[2]),
    }
    for k, v in [("mIoU02", mIoU02), ("latency02", latency02),
                 ("mIoU12", mIoU12), ("latency12", latency12)]:
        if v is not None:
            payload[k] = np.float64(v)
    np.savez_compressed(path, **payload)


def load_arch(path: str):
    from ..core.genotype import ArchParams
    return ArchParams.from_npz(path)
