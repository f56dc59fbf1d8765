"""Resizes on which the resize kernel (`kernels.resize_bilinear`) is held:
the plain version against the contraction on the CPU
(tests/test_torch_kernels.py), the CUDA kernel against the plain version and
the contraction on the card (tests/test_torch_cuda.py). Imports no JAX. A
case is ((N, H, W, C), (Ho, Wo), relu)."""

import torch

# The serving path's resizes at 256x512, as models/fast_body.py calls them
# for the student's plan (25 a class map) and the teacher's (50): zoomed
# cells' /2 and x2 (+ReLU at stride 1) and the aggregation's x2 and x4
STUDENT_RESIZES = [
    ((1, 4, 8, 128), (8, 16), True), ((1, 4, 8, 256), (8, 16), True),
    ((1, 8, 16, 64), (16, 32), True), ((1, 8, 16, 128), (4, 8), False),
    ((1, 8, 16, 128), (16, 32), False), ((1, 8, 16, 128), (16, 32), True),
    ((1, 8, 16, 192), (16, 32), True), ((1, 16, 32, 32), (32, 64), True),
    ((1, 16, 32, 64), (8, 16), False), ((1, 16, 32, 64), (32, 64), False),
    ((1, 16, 32, 128), (8, 16), False), ((1, 16, 32, 192), (8, 16), False),
    ((1, 32, 64, 32), (16, 32), False)]
TEACHER_RESIZES = [
    ((1, 8, 16, 192), (16, 32), False), ((1, 8, 16, 192), (16, 32), True),
    ((1, 16, 32, 96), (32, 64), False), ((1, 16, 32, 96), (32, 64), True),
    ((1, 16, 32, 192), (8, 16), False), ((1, 32, 64, 96), (16, 32), False)]
# `InferenceRunner.logits`' x8 of the 19 class logits (fp32 in evaluation)
LOGITS_X8 = [((1, 32, 64, 19), (256, 512), False)]
SERVING_RESIZES = STUDENT_RESIZES + TEACHER_RESIZES + LOGITS_X8

# What only the wrapper's generality reaches: channel counts off the 16-byte
# vector (one element a thread), two images, an axis that keeps its size,
# one output row, one source column, sizes no power of two divides
EDGE_RESIZES = [
    ((2, 7, 9, 19), (13, 4), False), ((1, 5, 6, 8), (5, 11), True),
    ((1, 6, 5, 3), (1, 9), False), ((1, 9, 1, 16), (4, 7), True),
    ((1, 9, 17, 12), (4, 33), True)]

# (in, out) sizes of one axis whose taps are held against the matrix: the
# serving factors, the x8, and the edges (out = 1, in = 1, the same size)
TAP_SIZES = [(64, 32), (32, 64), (16, 8), (8, 16), (4, 8), (8, 4), (32, 256),
             (64, 512), (7, 13), (13, 4), (5, 1), (1, 9), (6, 6)]


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units of the last place of their dtype (bf16 or fp32; 0
    between -0 and +0)."""
    itype, sign = {torch.bfloat16: (torch.int16, 15),
                   torch.float32: (torch.int32, 31)}[a.dtype]

    def ordered(t):
        i = t.view(itype).long()
        return torch.where(i < 0, -(i & ((1 << sign) - 1)), i)

    return (ordered(a) - ordered(b)).abs()
