"""Hand-written CUDA kernels (sources under ``csrc/``), each beside its plain
torch version."""
