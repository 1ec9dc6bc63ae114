"""Input construction, after ``repro.models.inputs``: what a batch of each
arch family holds (shapes and dtypes), and concrete random batches.

The modality frontends are stubs, as in the reference: an audio encoder
takes precomputed frame embeddings in place of tokens, and a vision decoder
takes patch embeddings that replace the token embeddings where
``embeds_mask`` is set, with 3-axis (t, h, w) position ids for M-RoPE.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

Spec = Tuple[Tuple[int, ...], torch.dtype]


def train_batch_spec(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Spec]:
    """Name -> (shape, dtype) of every field of a batch."""
    spec: Dict[str, Spec] = {
        "tokens": ((batch, seq), torch.int32),
        "targets": ((batch, seq), torch.int32),
        "loss_mask": ((batch, seq), torch.float32),
    }
    if cfg.frontend == "audio":
        spec["embeds"] = ((batch, seq, cfg.d_model), torch.bfloat16)
        del spec["tokens"]
    elif cfg.frontend == "vision":
        spec["embeds"] = ((batch, seq, cfg.d_model), torch.bfloat16)
        spec["embeds_mask"] = ((batch, seq), torch.bool)
        spec["positions"] = ((3, batch, seq), torch.int32)
    return spec


def decode_token_spec(cfg: ModelConfig, batch: int) -> Spec:
    return ((batch, 1), torch.int32)


def make_train_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """A random batch matching ``train_batch_spec``: the reference's numpy
    draws in the reference's order, so both packages build equal batches
    from one seed (the first ``seq // 8`` positions of a vision batch are
    patch embeddings; its positions are text-like, equal on all 3 axes)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def ints(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    def bf16(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dtype=torch.bfloat16, device=dev)

    out: Dict[str, torch.Tensor] = {
        "targets": ints(rng.integers(0, cfg.vocab_size, (batch, seq))),
        "loss_mask": torch.ones((batch, seq), dtype=torch.float32, device=dev),
    }
    if cfg.frontend == "audio":
        out["embeds"] = bf16(rng.normal(0, 1, (batch, seq, cfg.d_model)))
    else:
        out["tokens"] = ints(rng.integers(0, cfg.vocab_size, (batch, seq)))
    if cfg.frontend == "vision":
        n_patch = max(seq // 8, 1)
        mask = np.zeros((batch, seq), bool)
        mask[:, :n_patch] = True
        out["embeds"] = bf16(rng.normal(0, 1, (batch, seq, cfg.d_model)))
        out["embeds_mask"] = torch.as_tensor(mask, device=dev)
        pos = np.broadcast_to(np.arange(seq)[None, None], (3, batch, seq)).copy()
        out["positions"] = ints(pos)
    return out
