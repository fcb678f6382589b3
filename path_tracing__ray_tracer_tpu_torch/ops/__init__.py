"""Device ops in plain torch, and the CUDA kernels under ``ops/cuda``."""
