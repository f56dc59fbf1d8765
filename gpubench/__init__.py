"""Benchmark of fasterseg_tpu_torch on NVIDIA GPUs (see run.py)."""
