"""Meshes, after ``repro.launch.mesh``: named axes and their sizes.

Single pod: (16, 16) = 256 chips, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 chips, axes (pod, data, model) — ``pod`` is a
second data-parallel axis crossing the inter-pod boundary.

The sharding rules (``runtime.sharding``) need only the axis sizes, so a mesh
here is its axis names and sizes, plus the one device it runs on when it is
concrete. ``make_mesh`` builds a one-device mesh (every axis of size 1); a
mesh over several GPUs, with its process group and collectives, is not
ported. ``make_abstract_mesh`` and ``make_production_mesh`` hold no device:
they serve the spec logic and the dry-run.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device


class PartitionSpec(tuple):
    """Per dimension, the mesh axis (a name), the axes (a tuple of names) or
    ``None`` it is split over — the reference's ``PartitionSpec``, a tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """Named mesh axes with their sizes; ``device`` is the device a concrete
    (one-device) mesh runs on, ``None`` for an abstract one."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device: Optional[torch.device] = None):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes {tuple(axes)}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device = device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        where = "abstract" if self.device is None else str(self.device)
        return f"Mesh({self.shape}, {where})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, axes)


def make_mesh(shape, axes, device="cuda") -> Mesh:
    """A concrete mesh on one device (CUDA unless the caller asks for the
    CPU): every axis must have size 1."""
    if math.prod(int(s) for s in shape) != 1:
        raise ValueError(f"make_mesh{tuple(shape)}: one device per mesh; a mesh over several "
                         "GPUs is not ported (use make_abstract_mesh for the spec logic)")
    return Mesh(shape, axes, resolve_device(device))


def make_abstract_mesh(shape, axes) -> Mesh:
    """Device-free mesh (spec logic only needs axis sizes, not devices)."""
    return Mesh(shape, axes)
