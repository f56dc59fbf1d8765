"""Bilinear align-corners resize of NHWC maps, both axes in one launch, with
an optional ReLU: wrapper of csrc/resize_bilinear.cu.

The serving path's resizes (models/fast_body.py: the zoomed cells' /2 and
x2, the aggregation's; models/infer.py: `.logits`' x8) run here. The
function is ops/resize.py's contraction `resize_bilinear` (for fp32 maps
`in_float64(resize_bilinear, ...)`), computed from the two nonzeros of each
row of its interpolation matrix (`taps`) with the same roundings: bf16 maps
sum in fp32 and round each axis's pass to bf16; fp32 maps sum in float64,
the H pass unrounded, and round once to fp32. The plain version does the
same arithmetic with PyTorch gathers, one tensor op at a time, and is taken
for CPU tensors only; a CUDA tensor runs the kernel or raises. The tap
tables are made once per (in, out, dtype, device) and kept on the device,
as `ops.resize.interp_matrix` keeps its matrices, so a call copies nothing
to the device and can be captured in a CUDA graph.

It replaces no TPU kernel: the JAX package leaves resizes to XLA einsums.
The autograd network (ops/resize.py, DerivedNet, training, search), the
row-window forms of an image split over H (`parallel.spatial.Block`) and
the evaluator's half-pixel resize keep the contractions.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..ops.resize import _ac_coords, _interp_matrix_np
from . import build

launches = {"resize_bilinear": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535    # the kernel's grid: an output row, an image
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("resize_bilinear").resize_bilinear
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def taps(in_size: int, out_size: int, dtype: torch.dtype
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, w_lo, w_hi) of each output coordinate of the align-corners
    resize from `in_size` to `out_size`: the columns and values of the
    nonzeros of its row of `ops.resize._interp_matrix_np`, the values
    rounded to `dtype` as `interp_matrix` casts them (kept as float32). A
    row with one nonzero (lo == hi, the weight 1) has w_hi = 0, as has a
    size that does not change (lo = hi = the row)."""
    if in_size == out_size:
        lo = np.arange(out_size, dtype=np.int32)
        return lo, lo, np.ones(out_size, np.float32), np.zeros(
            out_size, np.float32)
    lo, hi, _ = _ac_coords(in_size, out_size)
    m = _interp_matrix_np(in_size, out_size)
    rows = np.arange(out_size)
    w = torch.from_numpy(np.stack([m[rows, lo],
                                   np.where(hi == lo, 0, m[rows, hi])]))
    w = w.to(dtype).float().numpy()
    return lo, hi, w[0], w[1]


@functools.lru_cache(maxsize=None)
def _tap_table(in_size: int, out_size: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """`taps` as the kernel reads them: (out, 4) int32 rows (lo, hi, w_lo
    bits, w_hi bits) on `device`."""
    lo, hi, w_lo, w_hi = taps(in_size, out_size, dtype)
    table = np.stack([lo, hi, w_lo.view(np.int32), w_hi.view(np.int32)], 1)
    return torch.from_numpy(table).to(device)


def _check(x: torch.Tensor, out_hw) -> Tuple[int, int]:
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {_DTYPES}, got {x.dtype}")
    if x.ndim != 4 or min(x.shape) < 1:
        raise ValueError(f"x must be NHWC (N, H, W, C), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    Ho, Wo = int(out_hw[0]), int(out_hw[1])
    if not (0 < Ho <= _MAX_GRID_YZ and Wo > 0):
        raise ValueError(f"out_hw must be positive with H <= {_MAX_GRID_YZ}, "
                         f"got {(Ho, Wo)}")
    n, _, _, c = x.shape
    if n > _MAX_GRID_YZ:
        raise ValueError(f"at most {_MAX_GRID_YZ} images, got {n}")
    if max(x.numel(), n * Ho * Wo * c) >= 2 ** 31:
        raise ValueError("input and output must have fewer than 2^31 "
                         "elements")
    return Ho, Wo


def _two_tap(v: torch.Tensor, axis: int, t) -> torch.Tensor:
    """w_lo * v[lo] + w_hi * v[hi] along `axis`, each product and the sum
    rounded in v's dtype."""
    lo, hi, w_lo, w_hi = t
    shape = [1] * v.ndim
    shape[axis] = -1
    return (w_lo.view(shape) * v.index_select(axis, lo)
            + w_hi.view(shape) * v.index_select(axis, hi))


@functools.lru_cache(maxsize=None)
def _plain_taps(in_size: int, out_size: int, dtype: torch.dtype,
                acc: torch.dtype, device: torch.device):
    """`taps` as the plain version's gathers and weights, made outside
    inference mode (as `interp_matrix`), so that a forward under autograd
    may use them after an inference-mode forward has cached them."""
    lo, hi, w_lo, w_hi = taps(in_size, out_size, dtype)
    with torch.inference_mode(False):
        index = lambda a: torch.from_numpy(a.astype(np.int64)).to(device)
        weight = lambda a: torch.from_numpy(a).to(device=device, dtype=acc)
        return index(lo), index(hi), weight(w_lo), weight(w_hi)


def resize_bilinear_plain(x: torch.Tensor, out_hw: Tuple[int, int],
                          relu: bool = False) -> torch.Tensor:
    """Plain version (the wrapper's for CPU tensors; on a card, the kernel's
    yardstick): the H pass at every source column, then the W pass, as
    two-tap gathers. bf16: in fp32, each pass rounded to bf16; fp32: in
    float64, rounded once to fp32. Then torch.relu where asked."""
    Ho, Wo = _check(x, out_hw)
    _, H, W, _ = x.shape
    acc = torch.float64 if x.dtype == torch.float32 else torch.float32
    h = _two_tap(x.to(acc), 1, _plain_taps(H, Ho, x.dtype, acc, x.device))
    if x.dtype == torch.bfloat16:
        h = h.to(x.dtype).to(acc)
    out = _two_tap(h, 2, _plain_taps(W, Wo, x.dtype, acc, x.device))
    out = out.to(x.dtype)
    return torch.relu(out) if relu else out


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    relu: bool = False) -> torch.Tensor:
    """(N, H, W, C) bf16 or fp32 NHWC -> (N, Ho, Wo, C) align-corners
    bilinear, then ReLU where asked. A CUDA tensor runs the kernel; a CPU
    tensor runs the plain version."""
    Ho, Wo = _check(x, out_hw)
    if x.device.type == "cpu":
        return resize_bilinear_plain(x, (Ho, Wo), relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, H, W, c = x.shape
    out = torch.empty((n, Ho, Wo, c), dtype=x.dtype, device=x.device)
    ytaps = _tap_table(H, Ho, x.dtype, x.device)
    xtaps = _tap_table(W, Wo, x.dtype, x.device)
    # the launch goes to the current device: make it x's
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), ytaps.data_ptr(), xtaps.data_ptr(),
                       out.data_ptr(), n, H, W, c, Ho, Wo,
                       int(x.dtype == torch.bfloat16), int(relu),
                       torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"resize_bilinear launch failed: CUDA error {rc}")
    launches["resize_bilinear"] += 1
    return out
