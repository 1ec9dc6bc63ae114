"""Attention for the dense decoder, after ``repro.models.attention``:
MHA/GQA with QKV biases and RoPE, full (prefill) and cached-decode modes.

The projections and prefill attention are plain large products, left to
``torch`` as the JAX package leaves them to XLA. Tiered decode attention is
the fused CUDA kernel (``repro_torch.kernels``), reached through
``repro_torch.runtime.serve``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

# Above this sequence length prefill attention switches to the blockwise
# online-softmax path (O(S * blk) memory instead of O(S^2)).
CHUNKED_ATTN_THRESHOLD = 2048
Q_BLOCK = 512
KV_BLOCK = 1024


def init_attn_params(gen: torch.Generator, cfg: ModelConfig, lead=(),
                     dtype=torch.bfloat16, device="cpu") -> dict:
    """Attention weights with leading dims ``lead`` (the layer stack), in
    the reference layouts: wq [D, H, hd], wk/wv [D, KV, hd], wo [H, hd, D]."""
    hd = cfg.head_dim_()
    lead = tuple(lead)
    ax = len(lead)

    def init(shape, in_axis=0):
        return layers.dense_init(gen, lead + shape, in_axis=ax + in_axis, dtype=dtype,
                                 device=device)

    p = {
        "wq": init((cfg.d_model, cfg.n_heads, hd)),
        "wk": init((cfg.d_model, cfg.n_kv_heads, hd)),
        "wv": init((cfg.d_model, cfg.n_kv_heads, hd)),
        "wo": init((cfg.n_heads, hd, cfg.d_model), in_axis=1),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (cfg.n_heads, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros(lead + (cfg.n_kv_heads, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros(lead + (cfg.n_kv_heads, hd), dtype=dtype, device=device)
    if cfg.attn_out_bias:
        p["bo"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype, device=device)
    return p


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, positions
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> q [B,S,H,hd], k/v [B,S,KV,hd] with rope applied."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          q_offset: int = 0) -> torch.Tensor:
    """Softmax attention. q: [B,Sq,H,hd]; k/v: [B,Sk,KV,hd] (GQA broadcast).
    Exact O(S^2)-memory path, and the oracle of the chunked path."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    group = h // kv
    qg = q.reshape(b, sq, kv, group, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32), k.to(torch.float32))
    scores = scores / (hd**0.5)
    if causal:
        sk = k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where((qpos >= kpos)[None, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(torch.float32))
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _maybe_expand_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tp: int = 1):
    """GQA -> MHA expansion when kv heads cannot shard over a model axis of
    size ``tp`` (the reference's tensor-parallel layout fix). On one device
    (``tp`` 1) K and V pass through unchanged."""
    h = q.shape[2]
    kvh = k.shape[2]
    if kvh == h or tp <= 1 or kvh % tp == 0 or h % tp != 0:
        return k, v
    rep = h // kvh
    return torch.repeat_interleave(k, rep, dim=2), torch.repeat_interleave(v, rep, dim=2)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
                  ) -> torch.Tensor:
    """Blockwise exact attention: q blocks, inner kv blocks with
    online-softmax accumulators, f32 accumulation."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    kvh = k.shape[2]
    group = h // kvh
    q_blk = min(Q_BLOCK, sq)
    kv_blk = min(KV_BLOCK, sk)
    if sq % q_blk or sk % kv_blk:
        raise ValueError(f"sequence lengths {sq}, {sk} must divide the attention blocks")
    dev = q.device
    qf = q.to(torch.float32).reshape(b, sq // q_blk, q_blk, kvh, group, hd) / (hd**0.5)
    kf = k.to(torch.float32).reshape(b, sk // kv_blk, kv_blk, kvh, hd)
    vf = v.to(torch.float32).reshape(b, sk // kv_blk, kv_blk, kvh, hd)
    outs = []
    for qi in range(sq // q_blk):
        qb = qf[:, qi]
        qp = torch.arange(qi * q_blk, (qi + 1) * q_blk, device=dev)
        acc = torch.zeros((b, kvh, group, q_blk, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, kvh, group, q_blk), -1e30, dtype=torch.float32, device=dev)
        lsum = torch.zeros((b, kvh, group, q_blk), dtype=torch.float32, device=dev)
        for ki in range(sk // kv_blk):
            kp = torch.arange(ki * kv_blk, (ki + 1) * kv_blk, device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, kf[:, ki])
            if causal:
                s = torch.where((qp[:, None] >= kp[None, :])[None, None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            e = torch.exp(s - m_new[..., None])
            lsum = lsum * alpha + e.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskh->bkgqh", e, vf[:, ki])
            m = m_new
        outs.append(acc / torch.clamp(lsum, min=1e-30)[..., None])  # [b,kv,g,q_blk,hd]
    out = torch.stack(outs, dim=1).permute(0, 1, 4, 2, 3, 5)  # [b,nq,q_blk,kv,g,hd]
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attend_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """One-token decode against a dense KV cache, writing the new token's
    K/V into ``k_cache``/``v_cache`` [B, S_max, KV, hd] at ``cache_len`` in
    place. x: [B, 1, D] -> y [B, 1, D]."""
    b = x.shape[0]
    positions = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    k_cache[:, cache_len] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, cache_len] = v_new[:, 0].to(v_cache.dtype)
    h, hd = q.shape[2], q.shape[3]
    kvh = k_cache.shape[2]
    qg = q.reshape(b, kvh, h // kvh, hd)
    # bf16 operands, f32 products and sums (the reference's
    # preferred_element_type=f32); the weights round to the cache dtype.
    scores = torch.einsum(
        "bkgh,bskh->bkgs", qg.to(torch.float32), k_cache.to(torch.float32)
    ) / (hd**0.5)
    valid = torch.arange(k_cache.shape[1], device=x.device)[None, None, None, :] <= cache_len
    scores = torch.where(valid, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", w.to(torch.float32), v_cache.to(torch.float32))
    out = out.reshape(b, 1, h, hd).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if cfg.attn_out_bias:
        y = y + p["bo"]
    return y
