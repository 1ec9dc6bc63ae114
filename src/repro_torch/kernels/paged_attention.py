"""Paged decode attention: wrappers of the CUDA kernels
``csrc/paged_attention.cu`` (single-launch fused tiered attention) and
``csrc/paged_quant_attention.cu`` (flash partials over one pool, the
``use_fused(False)`` path), and their plain versions.

Replaces the Pallas megakernel
``repro/kernels/paged_attention.py::fused_tiered_attention``. One unified
page table whose rows carry ``(class_row, tier_code)`` walks every compressed
page of a sequence regardless of codec: the tier code picks the int8 or int4
class buffer, host-resident pages appear as sentinel rows that score only a
per-page key centroid (telemetry, never accumulated), the dense recent window
follows, and the logsumexp merge happens in the kernel — one launch per
(layer, decode step).

Bound by bytes: each valid page's compressed K and V are read once. Both
kernels split each sequence's work over a thread-block cluster of ``S``
blocks (``csrc/attn_split.cuh``): every block takes a contiguous share of
the sequence's valid rows for all heads, and the blocks merge their
``(acc, m, l)`` through distributed shared memory in rank order, in the same
launch. ``LAST_CLUSTER`` holds the cluster size of each kernel's last launch.
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
_CLUSTER = ctypes.POINTER(ctypes.c_int)

# Cluster size (blocks per sequence) of each kernel's last launch.
LAST_CLUSTER = {"fused_tiered_attention": 0, "paged_quant_attention": 0}


def _check_split_shape(name: str, h: int, kv: int, hd: int) -> None:
    """The shapes the split block takes (``csrc/attn_split.cuh``): a thread
    owns 16 or 32 head-dim values of one head, the lanes of a head are a
    power of two, and the heads' chunks fit 512 threads."""
    ok = h > 0 and kv > 0 and h % kv == 0 and any(
        hd % c == 0 and hd // c in (1, 2, 4, 8, 16, 32) and h * hd // c <= 512 for c in (16, 32))
    if not ok:
        raise ValueError(f"{name}: head_dim {hd} must be 16, 32, 64, 128 or 256, H ({h}) a "
                         f"multiple of KV ({kv}), and H * head_dim <= 16384")


def _kernel_q(q: torch.Tensor) -> torch.Tensor:
    """q as the kernels read it: bf16 or f32 (other types go to f32),
    contiguous."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        q = q.to(torch.float32)
    return q.contiguous()


def fused_tiered_attention_plain(
    q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, host_summary,
    recent_k, recent_v, uni_slot, uni_tier, recent_len, page_tokens: int,
):
    """The kernel's function in plain PyTorch, built from the per-pool
    oracles: each codec class is one ``paged_quant_attention`` pass over the
    unified-table columns where its tier code occurs, each row valid where
    the code names that class (a row of another code is masked by it, never
    read), host rows are ``host_page_mass`` over the columns where
    ``TIER_HOST`` occurs, and the partials merge by the kernel's rule
    (``ref.merge_ranks``: at the maximum over the non-empty ones; ``m`` is
    the largest valid score, 0 where ``l`` is 0). A class no column holds is
    skipped: its partial would have ``l`` 0, which the merge weighs 0. So
    each pass costs what the oracle's pass over that pool costs."""
    b, ms = uni_slot.shape
    dev = q.device
    rlen = torch.as_tensor(recent_len, dtype=torch.int32, device=dev).expand(b)
    parts = [ref.dense_recent_attention(q, recent_k, recent_v, rlen)]
    mass = torch.zeros((b, ms), dtype=torch.float32, device=dev)
    base = torch.full((b, ms), NEG_INF, dtype=torch.float32, device=dev)

    def columns(code):
        """The columns where ``code`` occurs, and where in them it does."""
        cols = (uni_tier == code).any(dim=0).nonzero()[:, 0]
        return cols, uni_tier[:, cols] == code

    for code, ops, bits in ((TIER_INT8, (k8, s8k, v8, s8v), 8), (TIER_INT4, (k4, s4k, v4, s4v), 4)):
        cols, sel = columns(code)
        n = cols.numel()
        if not n:
            continue
        iota = torch.arange(n, dtype=torch.int32, device=dev)[None].expand(b, n)
        out_u, m, lsum, pm, pb = ref.paged_quant_attention(
            q, *ops, torch.where(sel, uni_slot[:, cols], 0),
            torch.full((b,), n, dtype=torch.int32, device=dev), bits,
            slot_pos=torch.where(sel, iota, 2**30))
        parts.append((out_u, m, lsum))
        mass[:, cols] = torch.where(sel, pm, mass[:, cols])
        base[:, cols] = torch.where(sel, pb, base[:, cols])
    cols, sel = columns(TIER_HOST)
    if cols.numel():
        hm, hb = ref.host_page_mass(q, host_summary, torch.where(sel, uni_slot[:, cols], 0),
                                    torch.full((b,), cols.numel(), dtype=torch.int32, device=dev),
                                    page_tokens)
        mass[:, cols] = torch.where(sel, hm, mass[:, cols])
        base[:, cols] = torch.where(sel, hb, base[:, cols])

    acc, m_tot, l_tot = ref.merge_ranks(parts)
    out = acc / torch.clamp(l_tot, min=1e-30)[..., None]
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
    if not build.on_card(q):
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
    _check_split_shape(name, h, kv, hd)
    q = _kernel_q(q)
    f32, i32 = torch.float32, torch.int32
    for nm, x, dt, shape in (
        ("q", q, (f32, torch.bfloat16), (b, h, hd)),
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
    fn.argtypes = ([_P] * 20 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_float, _CLUSTER,
                                                      _P])
    fn.restype = ctypes.c_int
    ptrs = [x.data_ptr() for x in (
        q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, host_summary, recent_k, recent_v,
        uni_slot, uni_tier, recent_len, out, m, lsum, mass, base,
    )]
    qdiv = float(np.float32(hd**0.5))
    cluster = ctypes.c_int(0)
    err = fn(*ptrs, b, h, kv, hd, t, r, ms, int(q.dtype == torch.bfloat16), qdiv,
             float(page_tokens), ctypes.byref(cluster), build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(name)
    LAST_CLUSTER[name] = cluster.value
    return out, m, lsum, mass, base


def paged_quant_attention(
    q: torch.Tensor,  # [B, H, hd] f32/bf16
    k_pages: torch.Tensor,  # [P, T, KV, hd] int8 or [P, T, KV, hd//2] uint8
    k_scales: torch.Tensor,  # [P, T, KV] f32
    v_pages: torch.Tensor,
    v_scales: torch.Tensor,
    page_table: torch.Tensor,  # [B, MP] int32 pool rows (entries >= n_pages ignored)
    n_pages: torch.Tensor,  # [B] int32
    bits: int,
):
    """Flash partials over one pool (the ``use_fused(False)`` path): one
    launch of ``csrc/paged_quant_attention.cu``, replacing the Pallas kernel
    ``repro/kernels/paged_attention.py::paged_quant_attention``.

    Returns (out [B,H,hd] UNNORMALIZED f32, m [B,H] (0 for an empty pool),
    l [B,H], mass [B,MP], base [B,MP]); rows >= n_pages give mass 0 and base
    -1e30. Off the card (``build.on_card``) the plain version
    ``ref.paged_quant_attention`` runs. On the GPU the operands are checked,
    the valid table prefix is held to the pool's rows (one copy to the host;
    skipped while a CUDA graph is captured), and
    ``paged_quant_attention_launch`` launches the kernel."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if not build.on_card(q):
        return ref.paged_quant_attention(q, k_pages, k_scales, v_pages, v_scales,
                                         page_table, n_pages, bits)
    name = "paged_quant_attention"
    dev = q.device
    b, h, hd = q.shape
    p, t, kv = k_pages.shape[:3]
    mp = page_table.shape[1]
    _check_split_shape(name, h, kv, hd)
    q = _kernel_q(q)
    pay_dt, hdp = (torch.int8, hd) if bits == 8 else (torch.uint8, hd // 2)
    f32, i32 = torch.float32, torch.int32
    for nm, x, dt, shape in (
        ("q", q, (f32, torch.bfloat16), (b, h, hd)),
        ("k_pages", k_pages, pay_dt, (p, t, kv, hdp)),
        ("k_scales", k_scales, f32, (p, t, kv)),
        ("v_pages", v_pages, pay_dt, (p, t, kv, hdp)),
        ("v_scales", v_scales, f32, (p, t, kv)),
        ("page_table", page_table, i32, (b, mp)),
        ("n_pages", n_pages, i32, (b,)),
    ):
        build.check_operand(name, nm, x, dt, dev, shape)
    # The kernel trusts the valid table prefix: every entry must be a pool row.
    # A captured step skips the check (a copy to the host); the cache checks
    # its tables at every commit.
    if not build.capturing(dev):
        valid = torch.arange(mp, device=dev)[None] < n_pages[:, None]
        rows = page_table[valid]
        if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= p):
            raise IndexError(f"{name}: page table addresses rows outside the pool's {p} rows")
    return paged_quant_attention_launch(q, k_pages, k_scales, v_pages, v_scales, page_table,
                                        n_pages, bits)


def paged_quant_attention_launch(q, k_pages, k_scales, v_pages, v_scales, page_table, n_pages,
                                 bits: int):
    """The launch behind ``paged_quant_attention``, without its checks: the
    operands must already be what that wrapper accepts (CUDA, contiguous,
    the valid table prefix inside the pool). Allocates the outputs, launches
    the kernel once and counts the launch; no copy to the host."""
    name = "paged_quant_attention"
    dev = q.device
    b, h, hd = q.shape
    t, kv = k_pages.shape[1], k_pages.shape[2]
    mp = page_table.shape[1]
    f32 = torch.float32
    out = torch.empty((b, h, hd), dtype=f32, device=dev)
    m = torch.empty((b, h), dtype=f32, device=dev)
    lsum = torch.empty((b, h), dtype=f32, device=dev)
    mass = torch.empty((b, mp), dtype=f32, device=dev)
    base = torch.empty((b, mp), dtype=f32, device=dev)
    lib = build.load("paged_quant_attention")
    fn = lib.paged_quant_attention_launch
    fn.argtypes = [_P] * 12 + [ctypes.c_int] * 8 + [ctypes.c_float, _CLUSTER, _P]
    fn.restype = ctypes.c_int
    ptrs = [x.data_ptr() for x in (q, k_pages, k_scales, v_pages, v_scales, page_table,
                                   n_pages, out, m, lsum, mass, base)]
    qdiv = float(np.float32(hd**0.5))
    cluster = ctypes.c_int(0)
    err = fn(*ptrs, b, h, kv, hd, t, mp, bits, int(q.dtype == torch.bfloat16), qdiv,
             ctypes.byref(cluster), build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(name)
    LAST_CLUSTER[name] = cluster.value
    return out, m, lsum, mass, base
