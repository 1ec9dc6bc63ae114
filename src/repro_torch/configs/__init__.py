"""Architecture registry of the port: the configurations this slice serves.

Each entry is ``repro_torch/configs/<id>.py`` exposing ``CONFIG`` (full
scale) and ``SMOKE`` (reduced, CPU-runnable), copied from ``repro.configs``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, TierScapeRunConfig

ARCH_IDS = ["qwen1_5_4b"]


def _module(name: str):
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"arch {name!r} is not ported yet; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ARCH_IDS", "ModelConfig", "TierScapeRunConfig", "get", "get_smoke"]
