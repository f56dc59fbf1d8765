"""Fused x8 align-corners upsample + argmax: wrapper of
csrc/upsample8_argmax.cu.

Counterpart of the JAX package's pallas/fused.py `upsample8_argmax`. Known
difference: the Pallas kernel rounds its interpolation matrices and its
H-pass result to bf16 (fused.py:53,77-78); the port interpolates in fp32, as
the contract `upsample8_argmax_xla` (fused.py:101) does. The two can differ
at near-ties of the logits.

The source holds two kernels and `_plan` chooses between them on the host.
The tile kernel gives a block of 8 warps 32 output rows x 128 output columns:
the block stages the tile's source footprint in shared memory once, a warp
runs the H pass once an output row, and each lane runs the W pass and the
argmax for four adjacent columns out of three source columns. It serves
resizes of at most 24 channels (its argmax keeps the index as a sum of
powers of two in a float) whose tiles' footprints fit 48 KB of shared memory
and whose four-column groups span at most three source columns: the serving
head's x8 and anything from about x4 at 19 channels. The wrapper takes any
`out_hw` and any channel count, as the JAX function does, so the pixel
kernel (one thread an output pixel, its four source pixels read from global
memory) serves the rest: small factors, downsamples, more channels. Both
round alike, so the choice does not show in the class map. The source
indices and lerp weights of both come from `ops.resize._ac_coords`, padded
to whole tiles.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.resize import _ac_coords, resize_bilinear
from . import build

launches = {"upsample8_argmax": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535     # the pixel kernel's grid: a block row an output row
_TILE_H, _TILE_W = 32, 128  # the tile kernel's output tile (TILE_H, TILE_W)
_WARPS = 8              # its warps: rows of H-pass results in shared memory
_MAX_SMEM = 48 * 1024   # dynamic shared memory a block gets without opting in
_MAX_TILE_C = 24        # channels the tile kernel's argmax can index
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("upsample8_argmax")
        if lib.upsample8_argmax_tile() != _TILE_H << 20 | _TILE_W << 8 | _WARPS:
            raise RuntimeError("upsample8_argmax.cu's tile is not the "
                               f"{(_TILE_H, _TILE_W, _WARPS)} the wrapper plans for")
        fn = lib.upsample8_argmax
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _padded_coords(in_size: int, out_size: int, tile: int):
    """`_ac_coords` padded to a whole number of tiles by repeating the last
    entry, so that a tile past the edge reads valid coordinates."""
    pad = -out_size % tile
    return tuple(np.pad(a, (0, pad), mode="edge")
                 for a in _ac_coords(in_size, out_size))


@functools.lru_cache(maxsize=None)
def _coords(in_size: int, out_size: int, tile: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device)
                 for a in _padded_coords(in_size, out_size, tile))


@functools.lru_cache(maxsize=None)
def _plan(h8: int, w8: int, c: int, H: int, W: int) -> Tuple[int, int, int]:
    """(FR, FC, CP) of the tile kernel: the largest source footprint of a
    tile (rows ylo[first] .. yhi[last]; columns xlo[first] .. xlo[last] + 2,
    the three-column reach of the last lane) and the channel count padded to
    an odd multiple of 4 (a 16-byte column pitch that spreads neighbouring
    columns over the banks). (0, 0, 0) where the pixel kernel must serve:
    more than 24 channels, a lane's four columns start in more than two
    source columns, or the footprint, a row of H-pass results a warp and the
    tile's row coordinates exceed the shared memory."""
    if c > _MAX_TILE_C:
        return 0, 0, 0
    ylo, yhi, _ = _padded_coords(h8, H, _TILE_H)
    xlo, _, _ = _padded_coords(w8, W, _TILE_W)
    if int((xlo[3::4] - xlo[0::4]).max()) > 1:
        return 0, 0, 0
    fr = int((yhi[_TILE_H - 1::_TILE_H] - ylo[0::_TILE_H]).max()) + 1
    fc = int((xlo[_TILE_W - 1::_TILE_W] - xlo[0::_TILE_W]).max()) + 3
    cp = -(-c // 4) * 4
    cp += 4 if cp % 8 == 0 else 0
    if ((fr + _WARPS) * fc * cp + 3 * _TILE_H) * 4 > _MAX_SMEM:
        return 0, 0, 0
    return fr, fc, cp


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
    if p8.numel() >= 2 ** 31:
        raise ValueError("p8 must have fewer than 2^31 elements")
    _, h8, w8, c = p8.shape
    ylo, yhi, ty = _coords(h8, H, _TILE_H, p8.device)
    xlo, xhi, tx = _coords(w8, W, _TILE_W, p8.device)
    out = torch.empty((1, H, W), dtype=torch.int32, device=p8.device)
    # the launch goes to the current device: make it p8's
    with torch.cuda.device(p8.device):
        rc = _kernel()(p8.data_ptr(), ylo.data_ptr(), yhi.data_ptr(),
                       ty.data_ptr(), xlo.data_ptr(), xhi.data_ptr(),
                       tx.data_ptr(), out.data_ptr(), h8, w8, c, H, W,
                       int(p8.dtype == torch.bfloat16),
                       *_plan(h8, w8, c, H, W),
                       torch.cuda.current_stream(p8.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"upsample8_argmax launch failed: CUDA error {rc}")
    launches["upsample8_argmax"] += 1
    return out
