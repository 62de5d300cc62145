"""Hand-written CUDA kernels for Hopper (sources in ``pwcnet_tpu_torch/csrc``),
each with its ctypes wrapper, launch count and plain PyTorch version."""
