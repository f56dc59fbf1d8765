"""fasterseg_tpu_torch: FasterSeg serving, evaluation and training in
PyTorch and CUDA.

A port of the JAX package `fasterseg_tpu` for NVIDIA Hopper (H100): genotype
decode and planning (`core`), the derived network (`models`), its serving
runner, whole-image evaluation (`eval`), teacher/student training (`train`,
`data`, `utils.checkpoint`, `cli`), data parallelism over
`torch.distributed` (`parallel`), and hand-written CUDA kernels for the
three Pallas kernels of the JAX package (`kernels`, sources in `csrc/`). It
imports neither JAX nor
the JAX package. Entry points run on CUDA unless the caller passes
`device="cpu"`, where each kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"
