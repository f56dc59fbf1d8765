"""ctypes bindings for the native (C++) augmentation kernels of the train
data pipeline (`_native/augment.cpp`, a copy of the JAX package's).

The shared library is built with g++ at first use into
fasterseg_tpu_torch/build/ (not at import). Where no compiler is present,
`available()` is false and `preprocess.TrainPre` takes its numpy/cv2 path,
which computes the same augmentation. This is host-side data code, not a
device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                    "augment.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")
_SO = os.path.join(_BUILD, "libaugment.so")
_lib = None
_lock = threading.Lock()


def _build() -> bool:
    """g++ into a temporary file, then an atomic rename, so that processes
    building at once never load a half-written library."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        "-o", tmp, _SRC], check=True, capture_output=True)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        stale = (not os.path.exists(_SO)
                 or os.path.getmtime(_SO) < os.path.getmtime(_SRC))
        if stale and not _build():
            return None
        lib = ctypes.CDLL(_SO)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i = ctypes.c_int
        lib.resize_bilinear_u8.argtypes = [u8p, i, i, i, u8p, i, i]
        lib.resize_nearest_u8.argtypes = [u8p, i, i, i, u8p, i, i]
        lib.mirror_u8.argtypes = [u8p, i, i, i, u8p]
        lib.crop_pad_normalize.argtypes = [u8p, i, i, i, i, i, i, i,
                                           f32p, f32p, f32p]
        lib.crop_pad_u8.argtypes = [u8p, i, i, i, i, i, i,
                                    ctypes.c_uint8, u8p]
        for fn in (lib.resize_bilinear_u8, lib.resize_nearest_u8,
                   lib.mirror_u8, lib.crop_pad_normalize, lib.crop_pad_u8):
            fn.restype = None
        _lib = lib
        return lib


def available() -> bool:
    return get_lib() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _channels(img: np.ndarray) -> int:
    return img.shape[2] if img.ndim == 3 else 1


def resize_bilinear_u8(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2.INTER_LINEAR resize of a uint8 HW or HWC image to (dh, dw)."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((dh, dw) + img.shape[2:], np.uint8)
    lib.resize_bilinear_u8(_u8(img), img.shape[0], img.shape[1],
                           _channels(img), _u8(out), dh, dw)
    return out


def resize_nearest_u8(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2.INTER_NEAREST resize of a uint8 HW or HWC image to (dh, dw)."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((dh, dw) + img.shape[2:], np.uint8)
    lib.resize_nearest_u8(_u8(img), img.shape[0], img.shape[1],
                          _channels(img), _u8(out), dh, dw)
    return out


def mirror_u8(img: np.ndarray) -> np.ndarray:
    """Horizontal flip of a uint8 HW or HWC image."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty_like(img)
    lib.mirror_u8(_u8(img), img.shape[0], img.shape[1], _channels(img),
                  _u8(out))
    return out


def crop_pad_normalize(img: np.ndarray, pos_y: int, pos_x: int,
                       ch: int, cw: int, mean: Sequence[float],
                       std: Sequence[float]) -> np.ndarray:
    """The (ch, cw) window at (pos_y, pos_x) of a uint8 HWC image, as
    (x / 255 - mean) / std in float32, centre-padded with 0 where the image
    is smaller than the window."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    c = img.shape[2]
    out = np.empty((ch, cw, c), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.crop_pad_normalize(_u8(img), img.shape[0], img.shape[1], c,
                           pos_y, pos_x, ch, cw, _f32(mean), _f32(std),
                           _f32(out))
    return out


def crop_pad_u8(img: np.ndarray, pos_y: int, pos_x: int, ch: int, cw: int,
                pad: int = 255) -> np.ndarray:
    """The (ch, cw) window of a uint8 HW label map, centre-padded with
    `pad`."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((ch, cw), np.uint8)
    lib.crop_pad_u8(_u8(img), img.shape[0], img.shape[1], pos_y, pos_x,
                    ch, cw, pad, _u8(out))
    return out
