"""Hopper kernels of the port (CUDA C++ in ``repro_torch/csrc``), their
wrappers, their plain PyTorch versions and the dispatch layer.

``ops`` holds the dispatch the engine calls; ``ref`` the plain versions
every kernel is held to. Importing builds nothing: a kernel is compiled at
its first launch.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
