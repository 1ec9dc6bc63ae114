"""Architecture registry of the port: all ten architectures of the reference.

Each entry is ``repro_torch/configs/<id>.py`` exposing ``CONFIG`` (full
scale) and ``SMOKE`` (reduced, CPU-runnable), copied from ``repro.configs``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ParallelConfig, TierScapeRunConfig

ARCH_IDS = [
    "qwen1_5_4b", "zamba2_1_2b", "qwen3_32b", "internlm2_20b", "command_r_35b", "mamba2_780m",
    "qwen3_moe_235b", "dbrx_132b", "qwen2_vl_72b", "hubert_xlarge",
]


def _module(name: str):
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ARCH_IDS", "ModelConfig", "ParallelConfig", "TierScapeRunConfig", "get", "get_smoke"]
