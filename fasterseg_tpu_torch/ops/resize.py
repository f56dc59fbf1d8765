"""Bilinear resizes as constant-matrix contractions, and nearest resizes.

The reference network is stitched together with
`F.interpolate(..., mode='bilinear', align_corners=True)`. The port does not
call `F.interpolate`: on torch's CPU kernels its downsampling is about 1.7e-5
away from the exact result, which breaks the 1e-5 bars the JAX package holds
itself to (`tests/test_ops.py::test_downsample_half_matches_torch` fails on
the torch side for this reason, not the JAX side). Each axis is instead a
contraction with the (out, in) two-taps-per-row interpolation matrix built
exactly as the JAX package builds it, so both packages apply the same weights.
The eval protocol's half-pixel (cv2 `INTER_LINEAR`) resize is built the same
way from its own matrix; the nearest resize is an `index_select` with torch's
`mode='nearest'` index map.

Layout: NHWC (the JAX package's layout), H and W are the 3rd- and
2nd-to-last axes.

Row-window forms (`*_rows`), for an image split over H across ranks
(parallel/spatial.py): the output rows of a rank's block are the rows of the
global interpolation matrix for them, applied to the window of input rows
those rows touch (fetched from whichever ranks hold them). The W axis is
resized whole. `in_float64` runs a resize of fp32 values in float64, so
that a block's rows get the whole map's bits (the inference path does).
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
def _hp_interp_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) half-pixel bilinear matrix, cv2.INTER_LINEAR semantics:
    src = (i+0.5)*in/out - 0.5, edge-clamped 2-tap."""
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * (
        in_size / out_size) - 0.5
    lo = np.floor(src).astype(np.int64)
    t = (src - lo).astype(np.float32)
    lo_c = np.clip(lo, 0, in_size - 1)
    hi_c = np.clip(lo + 1, 0, in_size - 1)
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.arange(out_size), lo_c), 1.0 - t)
    np.add.at(m, (np.arange(out_size), hi_c), t)
    return m


@functools.lru_cache(maxsize=None)
def interp_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                  device: torch.device, half_pixel: bool = False
                  ) -> torch.Tensor:
    """The matrix on `device`, copied there once: a host-to-device copy on
    every resize would stall the host on the card's stream. It is made
    outside inference mode whatever the caller's mode, so that a training
    forward may save it for backward after an inference-mode forward has
    cached it."""
    build = _hp_interp_matrix_np if half_pixel else _interp_matrix_np
    with torch.inference_mode(False):
        return torch.from_numpy(build(in_size, out_size)).to(
            device=device, dtype=dtype)


def _interp_axis(x: torch.Tensor, out_size: int, axis: int,
                 half_pixel: bool = False) -> torch.Tensor:
    """1-D interpolation along `axis` (a matrix product in x's dtype, as the
    JAX package contracts in the compute dtype)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    m = interp_matrix(in_size, out_size, x.dtype, x.device, half_pixel)
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


def resize_bilinear_halfpixel(x: torch.Tensor,
                              out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.INTER_LINEAR-equivalent resize of an NHWC (or HWC) tensor, H then
    W: the eval protocol's resize of probability maps to full resolution."""
    h_axis = x.ndim - 3
    x = _interp_axis(x, out_hw[0], h_axis, half_pixel=True)
    return _interp_axis(x, out_hw[1], h_axis + 1, half_pixel=True)


@functools.lru_cache(maxsize=None)
def _nearest_coords(in_size: int, out_size: int) -> np.ndarray:
    """PyTorch `mode='nearest'` index map: src = floor(i * in/out)."""
    return np.minimum(
        (np.arange(out_size, dtype=np.float64) * (in_size / out_size)
         ).astype(np.int32), in_size - 1)


@functools.lru_cache(maxsize=None)
def _nearest_index(in_size: int, out_size: int,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_nearest_coords(in_size, out_size)).to(
        device=device, dtype=torch.int64)


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize (torch semantics) of an NHWC (or HWC)
    tensor of any dtype, label maps included."""
    h_axis = x.ndim - 3
    x = torch.index_select(
        x, h_axis, _nearest_index(x.shape[h_axis], out_hw[0], x.device))
    return torch.index_select(
        x, h_axis + 1,
        _nearest_index(x.shape[h_axis + 1], out_hw[1], x.device))


def in_float64(fn, x, *args):
    """fn(x, *args) with x's float32 values (x a tensor or a
    `parallel.spatial.Block`) widened to float64 and the result rounded back
    once. The products' sums then do not depend on how the BLAS library
    cuts them, which changes with their shapes: a block of rows of an image
    split over H must get the whole image's bits. Other dtypes run as
    they are."""
    if isinstance(x, torch.Tensor):
        return (fn(x.double(), *args).float() if x.dtype == torch.float32
                else fn(x, *args))
    if x.t.dtype != torch.float32:
        return fn(x, *args)
    out = fn(x.like(x.t.double()), *args)
    return out.like(out.t.float())


# ---- row-window forms: a block of rows of an image split over H ----


@functools.lru_cache(maxsize=None)
def _window_np(in_size: int, out_size: int, lo: int, hi: int,
               half_pixel: bool) -> Tuple[int, int, np.ndarray]:
    """(a, b, m): output rows [lo, hi) of the global (out, in) matrix touch
    the input rows [a, b) and no other; m is their (hi - lo, b - a) part."""
    build = _hp_interp_matrix_np if half_pixel else _interp_matrix_np
    m = build(in_size, out_size)[lo:hi]
    cols = np.flatnonzero(m.any(axis=0))
    a, b = (int(cols[0]), int(cols[-1]) + 1) if cols.size else (0, 0)
    return a, b, np.ascontiguousarray(m[:, a:b])


def row_window(in_size: int, out_size: int, lo: int, hi: int,
               half_pixel: bool = False) -> Tuple[int, int]:
    """The input rows [a, b) that output rows [lo, hi) of the resize from
    `in_size` to `out_size` rows read (an identity resize reads its own
    rows)."""
    if in_size == out_size:
        return lo, hi
    return _window_np(in_size, out_size, lo, hi, half_pixel)[:2]


@functools.lru_cache(maxsize=None)
def window_matrix(in_size: int, out_size: int, lo: int, hi: int,
                  dtype: torch.dtype, device: torch.device,
                  half_pixel: bool = False) -> torch.Tensor:
    """The (hi - lo, b - a) slice of the interpolation matrix for output
    rows [lo, hi), on `device`, copied there once (as `interp_matrix`)."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            _window_np(in_size, out_size, lo, hi, half_pixel)[2]).to(
                device=device, dtype=dtype)


def resize_window(xw: torch.Tensor, in_size: int, out_hw: Tuple[int, int],
                  lo: int, hi: int, half_pixel: bool = False) -> torch.Tensor:
    """Output rows [lo, hi) of the bilinear resize (align-corners, or with
    `half_pixel` cv2's sampling) of a map of `in_size` rows to `out_hw`,
    from its input rows xw = x[..., a:b, :, :], (a, b) = row_window(...)."""
    h_axis = xw.ndim - 3
    if in_size != out_hw[0]:
        m = window_matrix(in_size, out_hw[0], lo, hi, xw.dtype, xw.device,
                          half_pixel)
        moved = torch.movedim(xw, h_axis, -1)
        xw = torch.movedim(torch.matmul(moved, m.t()), -1, h_axis).contiguous()
    return _interp_axis(xw, out_hw[1], h_axis + 1, half_pixel)


def resize_bilinear_rows(x, out_hw: Tuple[int, int], out_part,
                         half_pixel: bool = False):
    """Row-window form of `resize_bilinear` (with `half_pixel`, of
    `resize_bilinear_halfpixel`). x: this rank's `parallel.spatial.Block`
    of an NHWC map; out_part: the partition of the output's out_hw[0] rows.
    Returns this rank's Block of the output (a collective: every rank
    calls it)."""
    windows = [row_window(x.height, out_hw[0], *out_part.block(r), half_pixel)
               for r in range(out_part.world)]
    lo, hi = out_part.block(x.ex.rank)
    return x.like(resize_window(x.rows(windows), x.height, out_hw, lo, hi,
                                half_pixel), out_part)


def resize_bilinear_halfpixel_rows(x, out_hw: Tuple[int, int], out_part):
    """Row-window form of `resize_bilinear_halfpixel`."""
    return resize_bilinear_rows(x, out_hw, out_part, half_pixel=True)


def scale_by_rows(x, factor: float):
    """Row-window form of `scale_by`: each block boundary b goes to
    int(b * factor)."""
    out_hw = (int(x.height * factor), int(x.t.shape[-2] * factor))
    return resize_bilinear_rows(
        x, out_hw, x.part.map(lambda b: int(b * factor), out_hw[0]))


def downsample_half_rows(x):
    """Row-window form of `downsample_half`: each block boundary b goes to
    b // 2."""
    out_hw = (x.height // 2, x.t.shape[-2] // 2)
    return resize_bilinear_rows(x, out_hw,
                                x.part.map(lambda b: b // 2, out_hw[0]))
