"""Tiered decode step, after ``repro.runtime.serve`` (dense family, one
device).

``make_tiered_decode_step`` is the paper's technique on the decode path: the
KV cache's warm/cold pages live in two device-resident quantized pools (host
tiers are managed outside the step, visible only as sentinel rows), and
attention runs as ONE fused pass over all pools + host sentinels + the dense
recent window per layer — the CUDA kernel with ``use_kernels=True``, the
plain oracle (``kernels.ref.fused_tiered_attention``) otherwise. Per-page
softmax mass, including the host pages' would-have-touched mass, comes back
as telemetry for the TierScape manager.
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
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.transformer import Model, layer_params


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


def make_tiered_decode_step(
    model: Model,
    ts_cfg: TierScapeRunConfig,
    use_kernels: bool = False,
    device="cuda",
):
    """Decode step over tiered KV pools for the dense family.

    Returns step_fn(params, token [B, 1], tkv, extra_state) -> (logits
    [B, 1, V], tkv', extra_state, telemetry) where telemetry maps "warm",
    "cold" and "host" to the per-layer normalized page hotness [L, B, MP].
    ``extra_state`` (the reference's SSM side-state) passes through.
    ``use_kernels`` runs the fused CUDA kernel (one launch per layer); the
    plain branch runs the oracle the kernel is held to."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, step asked for {dev}")
    cfg = model.cfg
    if cfg.family != "dense":
        raise NotImplementedError(f"tiered decode for family {cfg.family!r} is not ported yet")
    wb = int(ts_cfg.warm_bits)
    cb = int(ts_cfg.cold_bits)
    warm_cls = "c8" if wb == 8 else "c4"
    cold_cls = "c8" if cb == 8 else "c4"

    def attend_tiered(blk, x, layer_tkv, total_len, recent_len):
        """x [B,1,D]; one attention layer against pools + recent window.
        Each slot rotary-encodes at its own position and appends the new
        token at its own dense-window offset."""
        hn = layers.apply_norm(cfg.norm, blk["norm1"], x, cfg.norm_eps)
        positions = total_len[:, None]  # [B, 1]
        q, k_new, v_new = attn_mod._project_qkv(blk["attn"], cfg, hn, positions)
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

    def step(params, token, tkv: TieredKVState, extra_state=None):
        x = params["embed"][token]
        recent_len = tkv.recent_len
        total_len = tkv.total_len
        telemetry = {"warm": [], "cold": [], "host": []}
        new_recent_k, new_recent_v = [], []
        for li in range(tkv.recent_k.shape[0]):
            blk = layer_params(params["blocks"], li)
            layer_tkv = {f: getattr(tkv, f)[li] for f in LAYER_FIELDS}
            x, rk, rv, hot = attend_tiered(blk, x, layer_tkv, total_len, recent_len)
            hn = layers.apply_norm(cfg.norm, blk["norm2"], x, cfg.norm_eps)
            x = x + mlp_mod.mlp(blk["ffn"], cfg, hn)
            new_recent_k.append(rk)
            new_recent_v.append(rv)
            for k in telemetry:
                telemetry[k].append(hot[k])
        tkv = dataclasses.replace(
            tkv,
            recent_k=torch.stack(new_recent_k),
            recent_v=torch.stack(new_recent_v),
            recent_len=recent_len + 1,
            total_len=total_len + 1,
        )
        x = layers.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        logits = model._head(params, x)
        return logits, tkv, extra_state, {k: torch.stack(v) for k, v in telemetry.items()}

    return step
