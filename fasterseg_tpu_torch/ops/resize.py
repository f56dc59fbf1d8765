"""Align-corners bilinear resizes as constant-matrix contractions.

The reference network is stitched together with
`F.interpolate(..., mode='bilinear', align_corners=True)`. The port does not
call `F.interpolate`: on torch's CPU kernels its downsampling is about 1.7e-5
away from the exact result, which breaks the 1e-5 bars the JAX package holds
itself to (`tests/test_ops.py::test_downsample_half_matches_torch` fails on
the torch side for this reason, not the JAX side). Each axis is instead a
contraction with the (out, in) two-taps-per-row interpolation matrix built
exactly as the JAX package builds it, so both packages apply the same weights.

Layout: NHWC (the JAX package's layout), H and W are the 3rd- and
2nd-to-last axes.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _ac_coords(in_size: int, out_size: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Align-corners source indices (lo, hi) and lerp weight for each output
    position: src = i * (in-1)/(out-1)."""
    if out_size == 1:
        src = np.zeros(1, dtype=np.float64)
    else:
        src = np.arange(out_size, dtype=np.float64) * (
            (in_size - 1) / (out_size - 1))
    lo = np.clip(np.floor(src).astype(np.int32), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    t = (src - lo).astype(np.float32)
    return lo, hi, t


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) align-corners interpolation matrix (2 taps per row)."""
    lo, hi, t = _ac_coords(in_size, out_size)
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.arange(out_size), lo), 1.0 - t)
    np.add.at(m, (np.arange(out_size), hi), t)
    return m


@functools.lru_cache(maxsize=None)
def interp_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """The matrix on `device`, copied there once: a host-to-device copy on
    every resize would stall the host on the card's stream."""
    return torch.from_numpy(_interp_matrix_np(in_size, out_size)).to(
        device=device, dtype=dtype)


def _interp_axis(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """1-D align-corners interpolation along `axis` (a matrix product in
    x's dtype, as the JAX package contracts in the compute dtype)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    m = interp_matrix(in_size, out_size, x.dtype, x.device)
    moved = torch.movedim(x, axis, -1)
    out = torch.matmul(moved, m.t())
    return torch.movedim(out, -1, axis).contiguous()


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear align-corners resize of an NHWC (or HWC) tensor, H then W."""
    h_axis = x.ndim - 3
    x = _interp_axis(x, out_hw[0], h_axis)
    return _interp_axis(x, out_hw[1], h_axis + 1)


def scale_by(x: torch.Tensor, factor: float) -> torch.Tensor:
    """F.interpolate(scale_factor=f, align_corners=True) equivalent."""
    h_axis = x.ndim - 3
    return resize_bilinear(x, (int(x.shape[h_axis] * factor),
                               int(x.shape[h_axis + 1] * factor)))


def downsample_half(x: torch.Tensor) -> torch.Tensor:
    """Bilinear align-corners downsample to (H//2, W//2): the front half of
    the reference's 'zoomed conv'."""
    h_axis = x.ndim - 3
    return resize_bilinear(x, (x.shape[h_axis] // 2, x.shape[h_axis + 1] // 2))
