"""Architecture registry of the port: all ten architectures of the reference,
and the input-shape cells each one runs.

Each entry is ``repro_torch/configs/<id>.py`` exposing ``CONFIG`` (full
scale) and ``SMOKE`` (reduced, CPU-runnable), copied from ``repro.configs``.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    MoEConfig,
    ParallelConfig,
    ShapeConfig,
    SSMConfig,
    TierScapeRunConfig,
)

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


def arch_ids() -> List[str]:
    return list(ARCH_IDS)


def cells_for(name: str) -> List[str]:
    """The shape cells an arch runs: every arch trains and prefills, the
    decoders decode, and the SSM and hybrid families take the 500k-token
    decode."""
    cfg = get(name)
    cells = ["train_4k", "prefill_32k"]
    if cfg.is_decoder:
        cells.append("decode_32k")
    if cfg.family in ("ssm", "hybrid"):
        cells.append("long_500k")
    return cells


def skipped_cells_for(name: str) -> List[str]:
    return [s for s in SHAPES if s not in cells_for(name)]


__all__ = [
    "ARCH_IDS",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "ParallelConfig",
    "TierScapeRunConfig",
    "SHAPES",
    "get",
    "get_smoke",
    "arch_ids",
    "cells_for",
    "skipped_cells_for",
]
