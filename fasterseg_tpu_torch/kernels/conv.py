"""3x3 conv + folded BN (+ReLU): wrapper of csrc/conv3x3_bn_relu.cu.

Counterpart of the JAX package's pallas/conv.py (`conv3x3_bn_relu_planar`
and `conv3x3s2_bn_relu_s2d`). The port keeps NHWC activations and HWIO
weights, the JAX package's public layouts; the planar, lane-padded and
space-to-depth layouts of the Pallas kernels are not reproduced.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..ops.conv import fold_bn  # noqa: F401  (pallas/conv.py:38 counterpart)
from . import build

# launches of the CUDA kernel, by stride (the Pallas originals are two
# kernels: the planar stride-1 one and the space-to-depth stride-2 one)
launches = {1: 0, 2: 0}

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535     # the CUDA-core kernel: one block row per output row
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("conv3x3_bn_relu").conv3x3_bn_relu
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, w, scale, bias, stride):
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {_DTYPES}, got {x.dtype}")
    if any(t.dtype != torch.float32 for t in (w, scale, bias)):
        raise TypeError("w, scale and bias must be float32")
    if x.ndim != 4 or x.shape[0] != 1:
        raise ValueError(f"x must be (1, H, W, Ci), got {tuple(x.shape)}")
    ci = x.shape[3]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"w must be (3, 3, {ci}, Co), got {tuple(w.shape)}")
    co = w.shape[3]
    if tuple(scale.shape) != (co,) or tuple(bias.shape) != (co,):
        raise ValueError(f"scale and bias must be ({co},)")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    devices = {t.device for t in (x, w, scale, bias)}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on several devices: {devices}")


def conv3x3_bn_relu_plain(x, w, scale, bias, stride: int = 1,
                          relu: bool = True) -> torch.Tensor:
    """Plain version (same math): fp32 conv of the given values, fp32
    epilogue, rounded once to x's dtype. NHWC in and out."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.permute(3, 2, 0, 1).float(), stride=stride, padding=1)
    y = y.permute(0, 2, 3, 1) * scale + bias
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()


def conv3x3_bn_relu(x, w, scale, bias, stride: int = 1,
                    relu: bool = True) -> torch.Tensor:
    """x: (1, H, W, Ci) NHWC, float32 or bfloat16; w: (3, 3, Ci, Co) HWIO
    float32; scale/bias: (Co,) float32 folded BN. Returns (1, Ho, Wo, Co)
    in x's dtype, pad 1, accumulated in fp32 and rounded once.

    A CUDA tensor runs the kernel (on tensor cores for bf16 with
    Ci % 16 == 0, on CUDA cores otherwise); a CPU tensor runs the plain
    version."""
    _check(x, w, scale, bias, stride)
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, scale, bias, stride, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    _, H, W, ci = x.shape
    co = w.shape[3]
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    if ho > _MAX_GRID_Y:
        raise ValueError(f"output height {ho} exceeds the kernel's grid "
                         f"limit of {_MAX_GRID_Y} rows")
    y = torch.empty((1, ho, wo, co), dtype=x.dtype, device=x.device)
    rc = _kernel()(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                   bias.data_ptr(), y.data_ptr(), H, W, ci, co, stride,
                   int(relu), int(x.dtype == torch.bfloat16),
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_bn_relu launch failed: CUDA error {rc}")
    launches[stride] += 1
    return y
