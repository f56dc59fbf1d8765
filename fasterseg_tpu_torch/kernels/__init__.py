"""Hand-written CUDA kernels of the serving path and their plain versions.

A wrapper runs its CUDA kernel for CUDA tensors and its plain PyTorch
version only for CPU tensors. Each counts its kernel launches.
"""

from . import conv, fused
from .conv import conv3x3_bn_relu, conv3x3_bn_relu_plain, fold_bn
from .fused import upsample8_argmax, upsample8_argmax_plain


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {"conv3x3_bn_relu_s1": conv.launches[1],
            "conv3x3_bn_relu_s2": conv.launches[2],
            "upsample8_argmax": fused.launches["upsample8_argmax"]}


def reset_launch_counts() -> None:
    conv.launches.update({1: 0, 2: 0})
    fused.launches["upsample8_argmax"] = 0

