"""Hopper kernels of the port (CUDA C++ in ``repro_torch/csrc``), their
wrappers, their plain PyTorch versions and the dispatch layer."""
