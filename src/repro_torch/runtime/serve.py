"""Tiered decode step, after ``repro.runtime.serve`` (the dense, MoE, VLM
and hybrid families, one device).

``make_tiered_decode_step`` is the paper's technique on the decode path: the
KV cache's warm/cold pages live in two device-resident quantized pools (host
tiers are managed outside the step, visible only as sentinel rows), and
attention runs as ONE fused pass over all pools + host sentinels + the dense
recent window per layer — the CUDA kernel with ``use_kernels=True``, the
plain oracle (``kernels.ref.fused_tiered_attention``) otherwise. Per-page
softmax mass, including the host pages' would-have-touched mass, comes back
as telemetry for the TierScape manager. For the hybrid family the tiered KV
serves the shared attention block's applications, and the SSM groups between
them carry a (conv, ssm) side state through the step. A MoE layer runs its
FFN with each slot as one dispatch group of one token (capacity 4, so
nothing drops at decode). Under M-RoPE every slot rotates at its own
position on all three axes (text).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, TierScapeRunConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.transformer import (Model, block_ffn, layer_params, ssm_groups,
                                            ssm_layer_decode)

# Families the tiered step serves: the attention decoders.
TIERED_FAMILIES = ("dense", "moe", "vlm", "hybrid")


@dataclasses.dataclass
class TieredKVState:
    """Device-resident tiered KV state of the decode step.

    Payload storage is CODEC-CLASS-MAJOR: one shared int8-class buffer
    (``c8_*``) and one int4-class buffer (``c4_*``), each holding the rows of
    EVERY tier pool of that codec width. Per-pool page tables hold GLOBAL rows
    of the pool's class buffer. Host-resident pages are visible to the step
    as sentinel rows: a per-page key centroid (``host_summary``) + a sentinel
    table. The cache edits the class buffers in place (index writes); the
    decode step returns a new state with the new recent window."""

    c8_k: torch.Tensor  # [L, P8, T, KV, hd] int8 — shared int8-class rows
    c8_k_scales: torch.Tensor  # [L, P8, T, KV] f32
    c8_v: torch.Tensor
    c8_v_scales: torch.Tensor
    c4_k: torch.Tensor  # [L, P4, T, KV, hd//2] uint8 — shared int4-class rows
    c4_k_scales: torch.Tensor
    c4_v: torch.Tensor
    c4_v_scales: torch.Tensor
    warm_table: torch.Tensor  # [L, B, MPw] int32 — global class-buffer rows
    warm_n: torch.Tensor  # [L, B] int32
    cold_table: torch.Tensor
    cold_n: torch.Tensor
    recent_k: torch.Tensor  # [L, B, R, KV, hd] bf16
    recent_v: torch.Tensor
    recent_len: torch.Tensor  # [B] int32 — per-slot dense-window fill
    total_len: torch.Tensor  # [B] int32 — per-slot sequence position
    host_summary: torch.Tensor  # [L, Hs, KV, hd] f32 — host-page key centroids
    host_table: torch.Tensor  # [L, B, MP] int32 — sentinel rows -> summary slot
    host_n: torch.Tensor  # [L, B] int32


# Class-buffer payload fields by codec width; ``f"{cls}_{field}"``.
CLASS_FIELDS = ("k", "k_scales", "v", "v_scales")

# Per-layer fields the decode step reads.
LAYER_FIELDS = (
    "c8_k", "c8_k_scales", "c8_v", "c8_v_scales",
    "c4_k", "c4_k_scales", "c4_v", "c4_v_scales",
    "warm_table", "warm_n", "cold_table", "cold_n",
    "recent_k", "recent_v",
    "host_summary", "host_table", "host_n",
)


def class_rows_of(
    warm_pages: int, cold_pages: int, warm_bits: int = 8, cold_bits: int = 4
) -> Dict[int, int]:
    """Rows per codec-class buffer for the (warm, cold) pool pair, warm
    range first. An empty class keeps one dummy row so the kernel operands
    stay non-degenerate; ``TIER_INVALID`` masking guarantees it is never
    read."""
    rows = {8: 0, 4: 0}
    rows[warm_bits] += warm_pages
    rows[cold_bits] += cold_pages
    return {b: max(r, 1) for b, r in rows.items()}


def init_tiered_kv_state(
    cfg: ModelConfig,
    batch: int,
    *,
    page_tokens: int,
    warm_pages: int,
    cold_pages: int,
    max_pages_per_seq: int,
    recent_window: int,
    n_attn_layers: int,
    host_slots: Optional[int] = None,
    warm_bits: int = 8,
    cold_bits: int = 4,
    device="cuda",
) -> TieredKVState:
    dev = resolve_device(device)
    hd = cfg.head_dim_()
    kv = cfg.n_kv_heads
    la = n_attn_layers
    t = page_tokens
    hs = max(host_slots if host_slots is not None else cold_pages, 1)
    rows = class_rows_of(warm_pages, cold_pages, warm_bits, cold_bits)
    p8, p4 = rows[8], rows[4]

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def o(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    i32 = torch.int32
    return TieredKVState(
        c8_k=z((la, p8, t, kv, hd), torch.int8),
        c8_k_scales=o((la, p8, t, kv)),
        c8_v=z((la, p8, t, kv, hd), torch.int8),
        c8_v_scales=o((la, p8, t, kv)),
        c4_k=z((la, p4, t, kv, hd // 2), torch.uint8),
        c4_k_scales=o((la, p4, t, kv)),
        c4_v=z((la, p4, t, kv, hd // 2), torch.uint8),
        c4_v_scales=o((la, p4, t, kv)),
        warm_table=z((la, batch, max_pages_per_seq), i32),
        warm_n=z((la, batch), i32),
        cold_table=z((la, batch, max_pages_per_seq), i32),
        cold_n=z((la, batch), i32),
        recent_k=z((la, batch, recent_window, kv, hd), torch.bfloat16),
        recent_v=z((la, batch, recent_window, kv, hd), torch.bfloat16),
        recent_len=z((batch,), i32),
        total_len=z((batch,), i32),
        host_summary=z((la, hs, kv, hd), torch.float32),
        host_table=z((la, batch, max_pages_per_seq), i32),
        host_n=z((la, batch), i32),
    )


def check_tiered(cfg: ModelConfig) -> None:
    """Refuse what has no KV to tier: an attention-free model (the
    reference's message) and an encoder, which has no decode."""
    if not cfg.has_attention:
        raise ValueError("tiered KV serving needs attention layers")
    if cfg.family == "encoder":
        raise ValueError(f"{cfg.name}: family 'encoder' has no decode, so no KV to tier")
    if cfg.family not in TIERED_FAMILIES:
        raise ValueError(cfg.family)


def step_positions(cfg: ModelConfig, total_len: torch.Tensor) -> torch.Tensor:
    """Rotary positions of one decode step: each slot's ``total_len`` as
    [B, 1], or under M-RoPE as [3, B, 1] (the same text position on the t/h/w
    axes). The reference passes [B, 1] under M-RoPE too, which its
    ``apply_mrope`` reads as [3, B, S]: slot i's position then drives section
    i (ROADMAP §3)."""
    pos = total_len[:, None]
    return pos[None].expand(3, -1, -1) if cfg.mrope else pos


def make_tiered_decode_step(
    model: Model,
    ts_cfg: TierScapeRunConfig,
    use_kernels: bool = False,
    device="cuda",
):
    """Decode step over tiered KV pools for the attention decoders (dense,
    MoE, VLM) and the hybrid family.

    Returns step_fn(params, token [B, 1], tkv, extra_state) -> (logits
    [B, 1, V], tkv', extra_state', telemetry) where telemetry maps "warm",
    "cold" and "host" to the per-attention-layer normalized page hotness
    [L, B, MP]. For the hybrid, ``extra_state`` is the SSM side state
    (conv [L_ssm, B, K-1, C], ssm [L_ssm, B, H, P, N]) and comes back as new
    tensors (the input is not modified); for the dense family it passes
    through. ``use_kernels`` runs the fused CUDA kernel (one launch per
    attention layer); the plain branch runs the oracle the kernel is held
    to."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, step asked for {dev}")
    cfg = model.cfg
    check_tiered(cfg)
    wb = int(ts_cfg.warm_bits)
    cb = int(ts_cfg.cold_bits)
    warm_cls = "c8" if wb == 8 else "c4"
    cold_cls = "c8" if cb == 8 else "c4"

    def attend_tiered(blk, x, layer_tkv, total_len, recent_len):
        """x [B,1,D]; one attention layer against pools + recent window.
        Each slot rotary-encodes at its own position and appends the new
        token at its own dense-window offset."""
        hn = layers.apply_norm(cfg.norm, blk["norm1"], x, cfg.norm_eps)
        q, k_new, v_new = attn_mod._project_qkv(blk["attn"], cfg, hn,
                                                step_positions(cfg, total_len))
        # Per-slot write at index recent_len[b] (an index beyond the window
        # writes nothing, matching an inactive slot).
        r = layer_tkv["recent_k"].shape[1]
        at = torch.arange(r, dtype=torch.int32, device=x.device)[None, :] == recent_len[:, None]
        at = at[:, :, None, None]  # [B, R, 1, 1]
        recent_k = torch.where(at, k_new.to(layer_tkv["recent_k"].dtype), layer_tkv["recent_k"])
        recent_v = torch.where(at, v_new.to(layer_tkv["recent_v"].dtype), layer_tkv["recent_v"])

        # Class-major pools: pools of one codec class share the SAME tensor
        # object (the zero-concat contract ``ops._class_operands`` checks by
        # identity); tables hold global class-buffer rows.
        def pool_of(cls, table, n, bits):
            return {
                "k_pages": layer_tkv[f"{cls}_k"],
                "k_scales": layer_tkv[f"{cls}_k_scales"],
                "v_pages": layer_tkv[f"{cls}_v"],
                "v_scales": layer_tkv[f"{cls}_v_scales"],
                "page_table": layer_tkv[table],
                "n_pages": layer_tkv[n],
                "bits": bits,
            }

        pools = {
            "warm": pool_of(warm_cls, "warm_table", "warm_n", wb),
            "cold": pool_of(cold_cls, "cold_table", "cold_n", cb),
        }
        host = {
            "summary": layer_tkv["host_summary"],
            "table": layer_tkv["host_table"],
            "n": layer_tkv["host_n"],
            "page_tokens": layer_tkv[f"{warm_cls}_k"].shape[1],
        }
        if use_kernels:
            out, hot = kops.tiered_decode_attention(
                q[:, 0], pools, recent_k, recent_v, recent_len + 1, cfg,
                with_telemetry=True, host=host,
            )
        else:
            out, m_tot, l_tot, masses = kref.fused_tiered_attention(
                q[:, 0], pools, recent_k, recent_v, recent_len + 1, host=host
            )
            hot = {
                name: kops.page_hotness(mass, base, m_tot, l_tot)
                for name, (mass, base) in masses.items()
            }
        y = torch.einsum("bhk,hkd->bd", out.to(x.dtype), blk["attn"]["wo"])[:, None]
        if cfg.attn_out_bias:
            y = y + blk["attn"]["bo"]
        return x + y, recent_k, recent_v, hot

    def attn_layer(blk, x, tkv, g, telemetry, new_recent):
        """One attention layer (its MLP or MoE FFN included) over
        application ``g`` of the tiered state. The MoE FFN takes each slot
        as a group of one token."""
        layer_tkv = {f: getattr(tkv, f)[g] for f in LAYER_FIELDS}
        x, rk, rv, hot = attend_tiered(blk, x, layer_tkv, tkv.total_len, tkv.recent_len)
        hn = layers.apply_norm(cfg.norm, blk["norm2"], x, cfg.norm_eps)
        x = x + block_ffn(blk, cfg, hn)[0]
        new_recent[0].append(rk)
        new_recent[1].append(rv)
        for k in telemetry:
            telemetry[k].append(hot[k])
        return x

    def step(params, token, tkv: TieredKVState, extra_state=None):
        x = params["embed"][token]
        telemetry = {"warm": [], "cold": [], "host": []}
        new_recent = ([], [])
        if cfg.family == "hybrid":
            # The shared block's applications over the tiered KV, each
            # followed by its group of SSM layers.
            conv_states, ssm_states = extra_state
            new_conv, new_ssm = [], []
            for g, group in enumerate(ssm_groups(cfg)):
                x = attn_layer(params["shared"], x, tkv, g, telemetry, new_recent)
                for li in group:
                    x, cv, ss = ssm_layer_decode(layer_params(params["blocks"], li), cfg, x,
                                                 conv_states[li], ssm_states[li])
                    new_conv.append(cv)
                    new_ssm.append(ss)
            extra_state = (torch.stack(new_conv), torch.stack(new_ssm))
        else:
            for li in range(tkv.recent_k.shape[0]):
                x = attn_layer(layer_params(params["blocks"], li), x, tkv, li, telemetry,
                                 new_recent)
        tkv = dataclasses.replace(
            tkv,
            recent_k=torch.stack(new_recent[0]),
            recent_v=torch.stack(new_recent[1]),
            recent_len=tkv.recent_len + 1,
            total_len=tkv.total_len + 1,
        )
        x = layers.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        logits = model._head(params, x)
        return logits, tkv, extra_state, {k: torch.stack(v) for k, v in telemetry.items()}

    return step
