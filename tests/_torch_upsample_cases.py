"""Shapes and inputs on which `upsample8_argmax` is held: the plain version
against the JAX contract on the CPU (tests/test_torch_kernels.py) and the
CUDA kernels against the plain version on the card
(tests/test_torch_cuda.py). Imports neither JAX nor torch."""

import numpy as np

# Shapes the tile kernel can get wrong: an output that no tile and no group
# of four columns divides, one source row, one source column, one channel,
# the most channels it takes (24, padded to 28), a small factor whose
# footprint still fits it (x5), and resizes the pixel kernel serves (x3, x2,
# a downsample, 32 and 256 channels). (H8, W8, C, out_hw)
UPSAMPLE_SHAPES = [
    (16, 32, 19, None), (16, 32, 19, (100, 250)), (1, 32, 19, (5, 250)),
    (16, 1, 19, (128, 7)), (16, 32, 1, None), (16, 32, 24, None),
    (16, 32, 32, None), (16, 32, 19, (80, 160)), (24, 40, 19, (191, 317)),
    (16, 32, 19, (48, 96)), (16, 32, 19, (32, 64)), (16, 32, 19, (8, 40)),
    (16, 32, 256, None)]


def upsample_inputs(gen, h8, w8, c):
    """One-hot logits (+5 / -5) and random logits, fp32 numpy."""
    lbl = gen.integers(0, c, (1, h8, w8))
    onehot = np.full((1, h8, w8, c), -5.0, np.float32)
    np.put_along_axis(onehot, lbl[..., None], 5.0, axis=-1)
    return onehot, gen.standard_normal((1, h8, w8, c)).astype(np.float32)
