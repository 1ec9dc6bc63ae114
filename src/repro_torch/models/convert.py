"""Carry the JAX package's parameters (or any pytree of arrays) into the
port, given as numpy arrays: ``params_from_numpy(jax.tree.map(np.asarray,
params))``.

bf16 arrives from ``np.asarray`` as the ``ml_dtypes`` bfloat16 dtype, which
``torch.from_numpy`` refuses: it is recognized by name, viewed as uint16 and
reinterpreted as ``torch.bfloat16`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    a = np.asarray(arr)
    if not (a.flags.c_contiguous and a.flags.writeable):  # jax hands out read-only buffers
        a = np.array(a, order="C")  # (np.ascontiguousarray would make a 0-d array 1-d)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dicts/lists/tuples of numpy arrays -> the same tree of tensors
    on ``device`` (dtypes and layouts unchanged)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)
