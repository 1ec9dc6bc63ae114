"""Single-launch fused tiered decode attention: wrapper of the CUDA kernel
``csrc/paged_attention.cu``, and its plain version.

Replaces the Pallas megakernel
``repro/kernels/paged_attention.py::fused_tiered_attention``. One unified
page table whose rows carry ``(class_row, tier_code)`` walks every compressed
page of a sequence regardless of codec: the tier code picks the int8 or int4
class buffer, host-resident pages appear as sentinel rows that score only a
per-page key centroid (telemetry, never accumulated), the dense recent window
follows, and the logsumexp merge happens in the kernel — one launch per
(layer, decode step).

Bound by bytes: each valid page's compressed K and V are read once. The
kernel runs one block per sequence and walks the rows serially (the page's
``(mass, base)`` reduces over all heads), so at a small batch it fills few
SMs and sits far above that bound; see the note in the CUDA source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref

NEG_INF = ref.NEG_INF

# Tier codes carried by the unified page table.
TIER_INT8 = 0
TIER_INT4 = 1
TIER_HOST = 2
TIER_INVALID = -1

_P = ctypes.c_void_p


def fused_tiered_attention_plain(
    q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, host_summary,
    recent_k, recent_v, uni_slot, uni_tier, recent_len, page_tokens: int,
):
    """The kernel's function in plain PyTorch, built from the per-pool
    oracles: each codec class is one ``paged_quant_attention`` pass whose
    rows are valid where the tier code names that class, host rows are
    ``host_page_mass`` where the code is ``TIER_HOST``, and the partials
    merge at the maximum over the non-empty ones (the kernel's running max:
    ``m`` is the largest valid score, 0 where ``l`` is 0)."""
    b, ms = uni_slot.shape
    dev = q.device
    rlen = torch.as_tensor(recent_len, dtype=torch.int32, device=dev).expand(b)
    iota = torch.arange(ms, dtype=torch.int32, device=dev)[None].expand(b, ms)
    full = torch.full((b,), ms, dtype=torch.int32, device=dev)
    parts = [ref.dense_recent_attention(q, recent_k, recent_v, rlen)]
    mass = torch.zeros((b, ms), dtype=torch.float32, device=dev)
    base = torch.full((b, ms), NEG_INF, dtype=torch.float32, device=dev)
    for code, ops, bits in ((TIER_INT8, (k8, s8k, v8, s8v), 8), (TIER_INT4, (k4, s4k, v4, s4v), 4)):
        sel = uni_tier == code
        table = torch.where(sel, uni_slot, 0)
        pos = torch.where(sel, iota, 2**30)
        out_u, m, lsum, pm, pb = ref.paged_quant_attention(q, *ops, table, full, bits,
                                                             slot_pos=pos)
        parts.append((out_u, m, lsum))
        mass = torch.where(sel, pm, mass)
        base = torch.where(sel, pb, base)
    sel = uni_tier == TIER_HOST
    hm, hb = ref.host_page_mass(q, host_summary, torch.where(sel, uni_slot, 0), full, page_tokens)
    mass = torch.where(sel, hm, mass)
    base = torch.where(sel, hb, base)

    live = [torch.where(lsum > 0, m, NEG_INF) for _, m, lsum in parts]
    m_tot = torch.stack(live).amax(dim=0)
    m_tot = torch.where(m_tot > NEG_INF / 2, m_tot, 0.0)
    num = 0.0
    l_tot = 0.0
    for out_u, m, lsum in parts:
        w = torch.where(lsum > 0, torch.exp(m - m_tot), 0.0)
        num = num + out_u * w[..., None]
        l_tot = l_tot + lsum * w
    out = num / torch.clamp(l_tot, min=1e-30)[..., None]
    return out, m_tot, l_tot, mass, base


def fused_tiered_attention(
    q: torch.Tensor,  # [B, H, hd] f32/bf16
    k8: torch.Tensor,  # [P8, T, KV, hd] int8 (the int8 class buffer)
    s8k: torch.Tensor,  # [P8, T, KV] f32
    v8: torch.Tensor,
    s8v: torch.Tensor,
    k4: torch.Tensor,  # [P4, T, KV, hd//2] uint8 (the int4 class buffer)
    s4k: torch.Tensor,
    v4: torch.Tensor,
    s4v: torch.Tensor,
    host_summary: torch.Tensor,  # [Hs, KV, hd] f32 per-page key centroids
    recent_k: torch.Tensor,  # [B, R, KV, hd] bf16
    recent_v: torch.Tensor,
    uni_slot: torch.Tensor,  # [B, MS] int32
    uni_tier: torch.Tensor,  # [B, MS] int32 TIER_* codes
    recent_len: torch.Tensor,  # [B] int32
    page_tokens: int,
):
    """One launch over every tier + host sentinels + the recent window.

    Returns (out [B,H,hd] NORMALIZED f32, m [B,H], l [B,H], mass [B,MS],
    base [B,MS]): (m, l) are the fully merged logsumexp stats and mass/base
    follow the unified-table rows (pool pages: page mass at its local base;
    host sentinels: would-have-touched mass; invalid: 0 / NEG_INF)."""
    if q.device.type == "cpu":
        return fused_tiered_attention_plain(
            q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, host_summary,
            recent_k, recent_v, uni_slot, uni_tier, recent_len, page_tokens,
        )
    name = "fused_tiered_attention"
    dev = q.device
    b, h, hd = q.shape
    t, kv = k8.shape[1], k8.shape[2]
    ms = uni_slot.shape[1]
    r = recent_k.shape[1]
    if hd % 2 or hd > 256 or h % kv:
        raise ValueError(f"{name}: head_dim {hd} must be even and <= 256, H % KV == 0")
    qf = q.to(torch.float32).contiguous()
    f32, i32 = torch.float32, torch.int32
    for nm, x, dt, shape in (
        ("q", qf, f32, (b, h, hd)),
        ("k8", k8, torch.int8, (k8.shape[0], t, kv, hd)),
        ("s8k", s8k, f32, k8.shape[:3]),
        ("v8", v8, torch.int8, k8.shape),
        ("s8v", s8v, f32, k8.shape[:3]),
        ("k4", k4, torch.uint8, (k4.shape[0], t, kv, hd // 2)),
        ("s4k", s4k, f32, k4.shape[:3]),
        ("v4", v4, torch.uint8, k4.shape),
        ("s4v", s4v, f32, k4.shape[:3]),
        ("host_summary", host_summary, f32, (host_summary.shape[0], kv, hd)),
        ("recent_k", recent_k, torch.bfloat16, (b, r, kv, hd)),
        ("recent_v", recent_v, torch.bfloat16, (b, r, kv, hd)),
        ("uni_slot", uni_slot, i32, (b, ms)),
        ("uni_tier", uni_tier, i32, (b, ms)),
        ("recent_len", recent_len, i32, (b,)),
    ):
        build.check_operand(name, nm, x, dt, dev, shape)
    out = torch.empty((b, h, hd), dtype=f32, device=dev)
    m = torch.empty((b, h), dtype=f32, device=dev)
    lsum = torch.empty((b, h), dtype=f32, device=dev)
    mass = torch.empty((b, ms), dtype=f32, device=dev)
    base = torch.empty((b, ms), dtype=f32, device=dev)
    lib = build.load("paged_attention")
    fn = lib.fused_tiered_attention_launch
    fn.argtypes = [_P] * 20 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    ptrs = [x.data_ptr() for x in (
        qf, k8, s8k, v8, s8v, k4, s4k, v4, s4v, host_summary, recent_k, recent_v,
        uni_slot, uni_tier, recent_len, out, m, lsum, mass, base,
    )]
    qdiv = float(np.float32(hd**0.5))
    err = fn(*ptrs, b, h, kv, hd, t, r, ms, qdiv, float(page_tokens), build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(name)
    return out, m, lsum, mass, base
