"""Plain PyTorch versions of the kernels (the oracles), after
``repro.kernels.ref``.

They define the semantics the CUDA kernels reproduce: the CPU runs them in
place of the kernels, the CPU tests hold them to the JAX package, and the
chip smoke holds each kernel to them on the GPU.

KV-page quantization layout (serving hot path):
  page:    [T, KV, hd]  float source (T tokens per page)
  int8:    payload [T, KV, hd] int8, scales [T, KV] f32 (absmax over hd)
  int4:    payload [T, KV, hd//2] uint8 (lo nibble = even idx), scales as int8

Divisions by a constant go through a 0-dim tensor on the operand's device:
PyTorch's CUDA division by a Python scalar multiplies by the reciprocal,
which flips round-half-even quantization ties against the kernels' IEEE
division. The tensor is filled on the device (``new_full``), not copied from
the host, so a CUDA graph can capture the division.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.codecs import CXL_LINE_ELEMS, cxl_line_bits
from repro_torch.kernels.packing import QMAX, pack_int4, unpack_int4

NEG_INF = -1e30


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE ``x / c`` on every device (see the module docstring)."""
    return x / x.new_full((), c, dtype=torch.float32)


# ---------------------------------------------------------------------------
# KV-page quant / dequant
# ---------------------------------------------------------------------------


def quant_kv_page(page: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """page [..., T, KV, hd] -> (payload, scales [..., T, KV])."""
    x = page.to(torch.float32)
    amax = x.abs().amax(dim=-1)
    scale = torch.where(amax == 0, 1.0, _div(amax, QMAX[bits]))
    q = torch.clamp(torch.round(x / scale[..., None]), -QMAX[bits], QMAX[bits])
    if bits == 8:
        return q.to(torch.int8), scale
    return pack_int4(q), scale


def dequant_kv_page(payload: torch.Tensor, scales: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of quant_kv_page (returns f32)."""
    q = payload.to(torch.float32) if bits == 8 else unpack_int4(payload)
    return q * scales[..., None]


# -- cxl_hw: inline line-compressed far memory ------------------------------
# Software quantizes a page to dense int8 (the int8 codec's layout); the
# expander's controller narrows each 64-codeword hardware line to 4-bit
# storage when every value fits int4 range. The engine always reads back the
# dense int8 view: line_bits only changes stored/wire bytes, never values.


def cxl_encode_kv_page(page: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """page [..., T, KV, hd] -> (payload int8, scales [..., T, KV],
    line_bits [..., T, KV, hd // CXL_LINE_ELEMS] int32 in {4, 8})."""
    payload, scales = quant_kv_page(page, 8)
    return payload, scales, cxl_page_line_bits(payload)


def cxl_page_line_bits(payload: torch.Tensor) -> torch.Tensor:
    """Stored width of each hardware line of an int8 payload."""
    hd = payload.shape[-1]
    if hd % CXL_LINE_ELEMS:
        raise ValueError(f"hd {hd} not a multiple of the {CXL_LINE_ELEMS}-codeword line")
    return cxl_line_bits(payload).reshape(*payload.shape[:-1], hd // CXL_LINE_ELEMS)


def cxl_decode_kv_page(payload: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of cxl_encode_kv_page (controller decompression is inline and
    value-exact, so decode is the plain int8 dequant, f32)."""
    return dequant_kv_page(payload, scales, 8)


def cxl_page_line_ratio(line_bits: torch.Tensor) -> float:
    """Observed line-compression ratio over a batch of pages: nominal dense
    payload bits / stored line bits. In [1, 2]."""
    total = int(line_bits.to(torch.int64).sum())
    return float(8 * line_bits.numel()) / float(max(total, 1))


def transcode_kv_page(
    payload: torch.Tensor, scales: torch.Tensor, src_bits: int, dst_bits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Requantize pages between codec widths (int8 <-> int4): exactly the
    dequant -> quant composition. Same-width transcode is the identity."""
    if src_bits == dst_bits:
        return payload, scales
    return quant_kv_page(dequant_kv_page(payload, scales, src_bits), dst_bits)


# ---------------------------------------------------------------------------
# Paged decode attention over one quantized pool
# ---------------------------------------------------------------------------


def paged_quant_attention(
    q: torch.Tensor,  # [B, H, hd]
    k_pages: torch.Tensor,  # [P, T, KV, hd(|//2)] int8/uint8
    k_scales: torch.Tensor,  # [P, T, KV] f32
    v_pages: torch.Tensor,
    v_scales: torch.Tensor,
    page_table: torch.Tensor,  # [B, MP] int (pool page id; entries >= n_pages ignored)
    n_pages: torch.Tensor,  # [B] valid page-table prefix length
    bits: int,
    slot_pos: torch.Tensor = None,  # [B, MP] logical slot positions (default iota)
):
    """Flash-decoding partials over the pool's pages.

    Returns (out_unnorm [B,H,hd] f32, m [B,H], l [B,H],
             page_mass [B,MP], page_base [B,MP]). page_mass is the softmax
    mass of each page at its local base (page_base = the page's max score
    over heads and tokens); ``ops.page_hotness`` rebases it to the merged
    global (m, l)."""
    b, h, hd = q.shape
    mp = page_table.shape[1]
    kv = k_pages.shape[2]
    g = h // kv
    dev = q.device
    qf = _div(q.to(torch.float32).reshape(b, kv, g, hd), hd**0.5)

    # Page-table chunks with an online softmax: the working set stays
    # O(chunk) instead of the whole dequantized pool.
    chunk = min(mp, 128)
    pad = (-mp) % chunk
    if slot_pos is None:
        slot_pos = torch.arange(mp, dtype=torch.int32, device=dev)[None].expand(b, mp)
    table = page_table.to(torch.int64)
    if pad:
        table = torch.nn.functional.pad(table, (0, pad))
        slot_pos = torch.nn.functional.pad(slot_pos, (0, pad), value=2**30)
    acc = torch.zeros((b, kv, g, hd), dtype=torch.float32, device=dev)
    m_run = torch.full((b, kv, g), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, kv, g), dtype=torch.float32, device=dev)
    masses, bases = [], []
    for c0 in range(0, mp + pad, chunk):
        tbl = table[:, c0:c0 + chunk]
        pos = slot_pos[:, c0:c0 + chunk]
        k = dequant_kv_page(k_pages[tbl], k_scales[tbl], bits)  # [B,C,T,KV,hd]
        v = dequant_kv_page(v_pages[tbl], v_scales[tbl], bits)
        scores = torch.einsum("bkgh,bptkh->bkgpt", qf, k)  # [B,KV,G,C,T]
        valid = (pos < n_pages.to(pos.dtype)[:, None])[:, None, None, :, None]
        scores = torch.where(valid, scores, -torch.inf)

        c_max = scores.amax(dim=(3, 4))
        c_max = torch.where(torch.isfinite(c_max), c_max, NEG_INF)
        m_new = torch.maximum(m_run, c_max)
        shift = torch.where(m_new > NEG_INF / 2, m_new, 0.0)
        e = torch.where(valid, torch.exp(scores - shift[..., None, None]), 0.0)
        alpha = torch.where(m_run > NEG_INF / 2, torch.exp(m_run - shift), 0.0)
        l_run = l_run * alpha + e.sum(dim=(3, 4))
        acc = acc * alpha[..., None] + torch.einsum("bkgpt,bptkh->bkgh", e, v)
        m_run = m_new

        # Telemetry at each page's local max.
        p_base = scores.amax(dim=(1, 2, 4))  # [B,C]
        b_safe = torch.where(torch.isfinite(p_base), p_base, 0.0)
        e_loc = torch.where(
            valid, torch.exp(scores - b_safe[:, None, None, :, None]), 0.0
        )
        masses.append(e_loc.sum(dim=(1, 2, 4)))
        bases.append(torch.where(torch.isfinite(p_base), p_base, NEG_INF))
    page_mass = torch.cat(masses, dim=1)[:, :mp]
    page_base = torch.cat(bases, dim=1)[:, :mp]
    m_safe = torch.where(m_run > NEG_INF / 2, m_run, 0.0)
    return (
        acc.reshape(b, h, hd),
        m_safe.reshape(b, h),
        l_run.reshape(b, h),
        page_mass,
        page_base,
    )


def dense_recent_attention(
    q: torch.Tensor,  # [B, H, hd]
    recent_k: torch.Tensor,  # [B, R, KV, hd]
    recent_v: torch.Tensor,
    recent_len,  # scalar or [B]
):
    """Partials over the dense (uncompressed) recent window."""
    b, h, hd = q.shape
    kv = recent_k.shape[2]
    g = h // kv
    qf = _div(q.to(torch.float32).reshape(b, kv, g, hd), hd**0.5)
    scores = torch.einsum("bkgh,brkh->bkgr", qf, recent_k.to(torch.float32))
    r = recent_k.shape[1]
    rl = torch.as_tensor(recent_len, device=q.device).expand(b)
    valid = (torch.arange(r, device=q.device)[None] < rl[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, -torch.inf)
    m = scores.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.where(valid, torch.exp(scores - m_safe[..., None]), 0.0)
    lsum = e.sum(dim=-1)
    out = torch.einsum("bkgr,brkh->bkgh", e, recent_v.to(torch.float32))
    return out.reshape(b, h, hd), m_safe.reshape(b, h), lsum.reshape(b, h)


def merge_partials(parts: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """Exact merge of flash partials [(out_unnorm, m, l), ...] -> out [B,H,hd]."""
    m_tot = torch.stack([p[1] for p in parts]).amax(dim=0)
    num = 0.0
    den = 0.0
    for out_u, m, lsum in parts:
        w = torch.exp(m - m_tot)
        num = num + out_u * w[..., None]
        den = den + lsum * w
    den = torch.clamp(den, min=1e-30)
    return num / den[..., None]


def tiered_decode_attention(q, pools: dict, recent_k, recent_v, recent_len, cfg=None
                            ) -> torch.Tensor:
    """Full oracle: attention over N quantized tier pools + the dense recent
    window, merged exactly. ``pools`` maps tier name -> dict with keys
    (k_pages, k_scales, v_pages, v_scales, page_table, n_pages, bits).
    Returns out [B, H, hd] (f32)."""
    parts = [dense_recent_attention(q, recent_k, recent_v, recent_len)]
    for name in sorted(pools):
        p = pools[name]
        out_u, m, lsum, _, _ = paged_quant_attention(
            q, p["k_pages"], p["k_scales"], p["v_pages"], p["v_scales"],
            p["page_table"], p["n_pages"], p["bits"],
        )
        parts.append((out_u, m, lsum))
    return merge_partials(parts)


def merge_ranks(parts: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]):
    """The split attention kernels' merge of partials [(acc_unnorm, m, l),
    ...] (one per cluster rank, in rank order): m_tot is the largest m among
    the partials with l > 0 (0 where none has), each partial weighs
    exp(m - m_tot) where its l > 0 and 0 elsewhere, and acc and l are summed
    in list order. Returns (acc_unnorm, m, l) with m = 0 where l == 0; the
    fused kernel then normalizes out = acc / max(l, 1e-30)."""
    live = [torch.where(lsum > 0, m, NEG_INF) for _, m, lsum in parts]
    m_tot = torch.stack(live).amax(dim=0)
    m_tot = torch.where(m_tot > NEG_INF / 2, m_tot, 0.0)
    acc = 0.0
    l_tot = 0.0
    for out_u, m, lsum in parts:
        w = torch.where(lsum > 0, torch.exp(m - m_tot), 0.0)
        acc = acc + out_u * w[..., None]
        l_tot = l_tot + lsum * w
    return acc, torch.where(l_tot > 0, m_tot, 0.0), l_tot


def host_page_mass(
    q: torch.Tensor,  # [B, H, hd]
    summaries: torch.Tensor,  # [Hs, KV, hd] f32 per-page key centroids
    table: torch.Tensor,  # [B, MPh] summary-slot ids (sentinel rows)
    n_rows: torch.Tensor,  # [B] valid prefix length
    page_tokens: int,
):
    """Would-have-touched softmax mass for host-resident pages: the page's
    key centroid scored against q, charged for all ``page_tokens`` tokens,

        mass = T * sum_{kv,g} exp(s - max s),   base = max s

    Telemetry only: sentinels never contribute to (acc, m, l)."""
    b, h, hd = q.shape
    kv = summaries.shape[1]
    g = h // kv
    mp = table.shape[1]
    qf = _div(q.to(torch.float32).reshape(b, kv, g, hd), hd**0.5)
    kbar = summaries[table.to(torch.int64)]  # [B, MPh, KV, hd]
    s = torch.einsum("bkgh,bpkh->bkgp", qf, kbar.to(torch.float32))
    base = s.amax(dim=(1, 2))  # [B, MPh]
    mass = page_tokens * torch.exp(s - base[:, None, None, :]).sum(dim=(1, 2))
    valid = torch.arange(mp, device=q.device)[None] < n_rows.to(q.device)[:, None]
    return torch.where(valid, mass, 0.0), torch.where(valid, base, NEG_INF)


def fused_tiered_attention(q, pools: dict, recent_k, recent_v, recent_len, host: dict = None):
    """Oracle for the single-launch kernel: attention over N quantized tier
    pools + the dense recent window with an exact merge, plus per-pool
    page-mass telemetry and (when ``host`` is given) the would-have-touched
    mass of host sentinel rows.

    ``host`` holds ``summary`` [Hs, KV, hd], ``table`` [B, MPh], ``n`` [B]
    and ``page_tokens``. Returns (out [B,H,hd] normalized, m_tot [B,H],
    l_tot [B,H], masses {name: (mass, base)} incl. "host")."""
    b = q.shape[0]
    rlen = torch.as_tensor(recent_len, dtype=torch.int32, device=q.device).expand(b)
    parts = [dense_recent_attention(q, recent_k, recent_v, rlen)]
    masses = {}
    for name in sorted(pools):
        p = pools[name]
        out_u, m, lsum, mass, base = paged_quant_attention(
            q, p["k_pages"], p["k_scales"], p["v_pages"], p["v_scales"],
            p["page_table"], p["n_pages"], p["bits"],
        )
        parts.append((out_u, m, lsum))
        masses[name] = (mass, base)
    out = merge_partials(parts)
    m_tot = torch.stack([p[1] for p in parts]).amax(dim=0)
    l_tot = sum(p[2] * torch.exp(p[1] - m_tot) for p in parts)
    if host is not None:
        masses["host"] = host_page_mass(
            q, host["summary"], host["table"], host["n"], host["page_tokens"]
        )
    return out, m_tot, l_tot, masses


def tiered_page_masses(q, pools: dict) -> dict:
    """Per-tier (page_mass, page_base) telemetry; normalize with
    ``ops.page_hotness`` after merging."""
    out = {}
    for name, p in pools.items():
        _, _, _, mass, base = paged_quant_attention(
            q, p["k_pages"], p["k_scales"], p["v_pages"], p["v_scales"],
            p["page_table"], p["n_pages"], p["bits"],
        )
        out[name] = (mass, base)
    return out
