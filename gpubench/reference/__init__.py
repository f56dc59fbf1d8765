"""The plain reference the benchmark holds the port against: plain PyTorch
and NumPy, importing nothing of the port and no JAX."""
