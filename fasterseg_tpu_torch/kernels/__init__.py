"""Hand-written CUDA kernels of the serving path and their plain versions.

A wrapper runs its CUDA kernel for CUDA tensors and its plain PyTorch
version only for CPU tensors. Each counts its kernel launches. Entry points
pick their device by the same rule (`resolve_device`).
"""

from typing import Union

import torch

from . import conv, fused, resize
from .conv import (ConvWeights, conv3x3_bn_relu, conv3x3_bn_relu_plain, fold_bn,
                   input_parts, round_tf32, split_weights, unpack_weights)
from .fused import upsample8_argmax, upsample8_argmax_plain
from .resize import resize_bilinear, resize_bilinear_plain


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on; CUDA must be present when asked
    for (the default), the CPU is used only when the caller names it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return device


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {"conv3x3_bn_relu_s1": conv.launches[1],
            "conv3x3_bn_relu_s2": conv.launches[2],
            "upsample8_argmax": fused.launches["upsample8_argmax"],
            "resize_bilinear": resize.launches["resize_bilinear"]}


def halo_launch_counts() -> dict:
    """Of the conv launches so far, those in halo mode (a block of an
    image split over H), by stride."""
    return {"conv3x3_bn_relu_s1": conv.halo_launches[1],
            "conv3x3_bn_relu_s2": conv.halo_launches[2]}


def route_launch_counts() -> dict:
    """Of the conv launches so far, those of each route of
    csrc/conv3x3_bn_relu.cu (`conv.ROUTES`), by route name."""
    return {f"conv3x3_bn_relu_{name}": conv.route_launches[r]
            for r, name in conv.ROUTES.items()}


def reset_launch_counts() -> None:
    conv.launches.update({1: 0, 2: 0})
    conv.halo_launches.update({1: 0, 2: 0})
    conv.route_launches.update({r: 0 for r in conv.ROUTES})
    fused.launches["upsample8_argmax"] = 0
    resize.launches["resize_bilinear"] = 0

