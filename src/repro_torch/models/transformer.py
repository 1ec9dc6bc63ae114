"""Dense decoder LM, after ``repro.models.transformer`` (family "dense"):

    model = Model(cfg, device="cuda")
    params = model.init(seed)                        # torch generator
    state = model.init_cache(batch, max_len)         # dense decode state
    logits, state = model.prefill(params, batch, state)
    logits, state = model.decode_step(params, tok, state)

Parameters are a plain dictionary in the reference layout: block weights
are stacked with a leading layer dim, and the layers run as a Python loop
(the reference's ``lax.scan``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, mlp


@dataclasses.dataclass
class DecodeState:
    """Stacked per-layer dense decode state."""

    k_cache: torch.Tensor  # [L_attn, B, S_max, KV, hd]
    v_cache: torch.Tensor
    cache_len: int  # tokens already in the cache


def _attn_layer_count(cfg: ModelConfig) -> int:
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return -(-cfg.n_layers // cfg.hybrid_attn_every)  # shared-block applications
    return 0


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cpu") -> DecodeState:
    hd = cfg.head_dim_()
    shape = (_attn_layer_count(cfg), batch, max_len, cfg.n_kv_heads, hd)
    return DecodeState(
        k_cache=torch.zeros(shape, dtype=dtype, device=device),
        v_cache=torch.zeros(shape, dtype=dtype, device=device),
        cache_len=0,
    )


def layer_params(tree, li: int):
    """One layer's slice of layer-stacked parameters (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, li) for k, v in tree.items()}
    return tree[li]


def check_supported(cfg: ModelConfig) -> None:
    """The port serves the dense family with RMSNorm, SwiGLU and 1-D RoPE;
    every other flavor raises instead of running something else."""
    unported = {
        "family": cfg.family != "dense",
        "norm": cfg.norm != "rmsnorm",
        "act": cfg.act != "swiglu",
        "qk_norm": cfg.qk_norm,
        "mrope": cfg.mrope,
        "frontend": cfg.frontend is not None,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported yet (the port serves "
            f"dense decoders with rmsnorm/swiglu/rope; see ROADMAP)"
        )


class Model:
    """Dense decoder (pure functions over a parameter dict + config)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, gen: Union[int, torch.Generator] = 0, dtype=torch.bfloat16) -> Dict[str, Any]:
        """Seeded random init on ``self.device`` (a seed or a generator)."""
        cfg = self.cfg
        dev = self.device
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        lead = (cfg.n_layers,)
        return {
            "embed": layers.embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, dev),
            "blocks": {
                "norm1": torch.ones(lead + (cfg.d_model,), dtype=torch.float32, device=dev),
                "attn": attention.init_attn_params(gen, cfg, lead, dtype, dev),
                "norm2": torch.ones(lead + (cfg.d_model,), dtype=torch.float32, device=dev),
                "ffn": mlp.init_mlp_params(gen, cfg, lead, dtype=dtype, device=dev),
            },
            "final_norm": layers.make_norm_params(cfg.norm, cfg.d_model, dev),
            **({} if cfg.tie_embeddings else {
                "lm_head": layers.dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype=dtype,
                                             device=dev),
            }),
        }

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x, params["embed"])
        return torch.matmul(x, params["lm_head"])

    def init_cache(self, batch_size: int, max_len: int, dtype=torch.bfloat16) -> DecodeState:
        return init_decode_state(self.cfg, batch_size, max_len, dtype, self.device)

    def prefill(self, params, batch: Dict[str, torch.Tensor], state: DecodeState
                ) -> Tuple[torch.Tensor, DecodeState]:
        """Run the full prompt, filling ``state`` (in place) with every
        layer's K/V. Returns last-token logits [B, 1, V]."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = params["embed"][tokens]
        bsz, seq = tokens.shape
        positions = torch.arange(seq, device=x.device)[None].expand(bsz, seq)
        for li in range(cfg.n_layers):
            blk = layer_params(params["blocks"], li)
            hn = layers.apply_norm(cfg.norm, blk["norm1"], x, cfg.norm_eps)
            q, k, v = attention._project_qkv(blk["attn"], cfg, hn, positions)
            ke, ve = attention._maybe_expand_kv(q, k, v)
            if q.shape[1] > attention.CHUNKED_ATTN_THRESHOLD:
                out = attention._sdpa_chunked(q, ke, ve, causal=cfg.causal)
            else:
                out = attention._sdpa(q, ke, ve, causal=cfg.causal)
            y = torch.einsum("bshk,hkd->bsd", out, blk["attn"]["wo"])
            if cfg.attn_out_bias:
                y = y + blk["attn"]["bo"]
            x = x + y
            hn = layers.apply_norm(cfg.norm, blk["norm2"], x, cfg.norm_eps)
            x = x + mlp.mlp(blk["ffn"], cfg, hn)
            state.k_cache[li, :, :seq] = k.to(state.k_cache.dtype)
            state.v_cache[li, :, :seq] = v.to(state.v_cache.dtype)
        state.cache_len = seq
        x = layers.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        return self._head(params, x[:, -1:]), state

    def decode_step(self, params, token: torch.Tensor, state: DecodeState
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """One token [B, 1] against the dense cache (updated in place)."""
        cfg = self.cfg
        x = params["embed"][token]
        pos = state.cache_len
        for li in range(cfg.n_layers):
            blk = layer_params(params["blocks"], li)
            hn = layers.apply_norm(cfg.norm, blk["norm1"], x, cfg.norm_eps)
            x = x + attention.attend_decode(
                blk["attn"], cfg, hn, state.k_cache[li], state.v_cache[li], pos
            )
            hn = layers.apply_norm(cfg.norm, blk["norm2"], x, cfg.norm_eps)
            x = x + mlp.mlp(blk["ffn"], cfg, hn)
        state.cache_len = pos + 1
        x = layers.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        return self._head(params, x), state
