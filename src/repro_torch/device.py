"""Device resolution for the port's entry points, and the abstract (``meta``)
build the launch tooling uses."""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Asking for CUDA where no GPU is present raises — there is no
    silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


class _MetaFactories(TorchFunctionMode):
    """Every torch call that names a ``device`` builds on ``meta`` instead."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "device" in kwargs:
            kwargs = dict(kwargs, device="meta")
        return func(*args, **kwargs)


@contextlib.contextmanager
def abstract():
    """Shapes and dtypes without storage, the port's ``jax.eval_shape``:
    inside, a builder called with ``device="cpu"`` (``Model.init`` with a
    CPU generator, ``init_cache``, ``init_tiered_kv_state``, the optimizer
    inits) makes ``meta`` tensors. Entry points still resolve their device
    through ``resolve_device``, which accepts only ``cuda`` and ``cpu``."""
    with _MetaFactories():
        yield
