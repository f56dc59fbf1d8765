"""Fused x8 align-corners upsample + argmax: wrapper of
csrc/upsample8_argmax.cu.

Counterpart of the JAX package's pallas/fused.py `upsample8_argmax`. Known
difference: the Pallas kernel rounds its interpolation matrices and its
H-pass result to bf16 (fused.py:53,77-78); the port interpolates in fp32, as
the contract `upsample8_argmax_xla` (fused.py:101) does. The two can differ
at near-ties of the logits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..ops.resize import _ac_coords, resize_bilinear
from . import build

launches = {"upsample8_argmax": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535     # one block row per output row (gridDim.y)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("upsample8_argmax").upsample8_argmax
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _coords(in_size: int, out_size: int, device: torch.device):
    lo, hi, t = _ac_coords(in_size, out_size)
    return tuple(torch.from_numpy(a.copy()).to(device) for a in (lo, hi, t))


def _out_hw(p8, out_hw):
    if p8.dtype not in _DTYPES:
        raise TypeError(f"p8 must be one of {_DTYPES}, got {p8.dtype}")
    if p8.ndim != 4 or p8.shape[0] != 1:
        raise ValueError(f"p8 must be (1, H8, W8, C), got {tuple(p8.shape)}")
    if out_hw is None:
        out_hw = (p8.shape[1] * 8, p8.shape[2] * 8)
    H, W = int(out_hw[0]), int(out_hw[1])
    if not (0 < H <= _MAX_GRID_Y and W > 0):
        raise ValueError(f"out_hw must be positive with H <= {_MAX_GRID_Y}, "
                         f"got {(H, W)}")
    return H, W


def upsample8_argmax_plain(p8: torch.Tensor,
                           out_hw: Optional[Tuple[int, int]] = None
                           ) -> torch.Tensor:
    """Plain version: fp32 matrix resize to full resolution, then argmax
    (first maximum wins). (1, H8, W8, C) -> (1, H, W) int32."""
    out_hw = _out_hw(p8, out_hw)
    logits = resize_bilinear(p8.float(), out_hw)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def upsample8_argmax(p8: torch.Tensor,
                     out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(1, H8, W8, C) logits -> (1, H, W) int32 class map, H x W = out_hw
    (default 8x the input). A CUDA tensor runs the kernel; a CPU tensor
    runs the plain version."""
    H, W = _out_hw(p8, out_hw)
    if p8.device.type == "cpu":
        return upsample8_argmax_plain(p8, (H, W))
    if p8.device.type != "cuda":
        raise ValueError(f"unsupported device {p8.device}")
    if not p8.is_contiguous():
        raise ValueError("p8 must be contiguous")
    _, h8, w8, c = p8.shape
    ylo, yhi, ty = _coords(h8, H, p8.device)
    xlo, xhi, tx = _coords(w8, W, p8.device)
    out = torch.empty((1, H, W), dtype=torch.int32, device=p8.device)
    rc = _kernel()(p8.data_ptr(), ylo.data_ptr(), yhi.data_ptr(),
                   ty.data_ptr(), xlo.data_ptr(), xhi.data_ptr(),
                   tx.data_ptr(), out.data_ptr(), w8, c, H, W,
                   int(p8.dtype == torch.bfloat16),
                   torch.cuda.current_stream(p8.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"upsample8_argmax launch failed: CUDA error {rc}")
    launches["upsample8_argmax"] += 1
    return out
