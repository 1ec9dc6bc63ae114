"""PyTorch/CUDA port of the tiered paged-KV serving system in ``repro``.

The JAX package ``repro`` is the reference; this package keeps its module
and public function names so each counterpart is easy to find, and never
imports it. Entry points run on the GPU (``device="cuda"``) unless the caller
passes ``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version.
"""
