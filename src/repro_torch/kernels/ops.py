"""Public dispatch for the kernels, after ``repro.kernels.ops`` (the fused
path).

``tiered_decode_attention`` is the serving hot path: the single-launch fused
kernel (``paged_attention.fused_tiered_attention``) walks one unified page
table over every compressed page of a sequence regardless of codec, the
dense recent window rides the same launch, host-resident pages appear as
sentinel rows emitting a "would-have-touched" mass, and the logsumexp merge
happens in the kernel — one launch per (layer, decode step), O(1) in tier
count. Each wrapper picks its kernel or its plain version from the device of
its tensors; ``build.launch_counts()`` counts the kernel launches.

``page_hotness`` turns per-page mass telemetry into the normalized hotness
the TierScape manager consumes; ``decode_launches_per_step`` is the modeled
launches-per-decode-step the serving cache bills, independent of device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.paged_attention import (
    TIER_HOST,
    TIER_INT4,
    TIER_INT8,
    TIER_INVALID,
    fused_tiered_attention as fused_attn_kernel,
)
from repro_torch.kernels.quant_page import quant_pages  # noqa: F401  (public dispatch name)
from repro_torch.kernels.transcode_page import transcode_pages  # noqa: F401  (same-width: identity)

# Device bytes materialized by per-step payload concatenation in
# ``_unified_operands`` since the last reset. Zero on the class-major layout
# (same-class pools alias one buffer); non-zero only for standalone per-pool
# buffers of one codec class.
_COPY_BYTES = 0


def use_fused(flag: bool) -> None:
    """The fused single-launch path is the only one ported; the per-pool
    launch loop (``use_fused(False)`` in the reference) comes with the
    ``paged_quant_attention`` kernel in a later slice."""
    if not flag:
        raise NotImplementedError(
            "use_fused(False): the per-pool attention path and its "
            "paged_quant_attention kernel are not ported yet (see ROADMAP)"
        )


def reset_copy_bytes() -> None:
    global _COPY_BYTES
    _COPY_BYTES = 0


def concat_copy_bytes() -> int:
    """Device bytes copied by payload concatenation since the last reset."""
    return _COPY_BYTES


def decode_launches_per_step(n_pools: int) -> int:
    """Modeled attention launches per (layer, decode step): 1 on the fused
    path regardless of tier count (host sentinels ride the same launch)."""
    return 1


# ---------------------------------------------------------------------------
# Unified-table construction (fused path)
# ---------------------------------------------------------------------------


_CLASS_KEYS = ("k_pages", "k_scales", "v_pages", "v_scales")


def _validated_page_tokens(pools, host) -> int:
    """THE page-tokens value of a fused launch: every device pool's page
    shape and the host sentinels' ``page_tokens`` must agree, because one
    unified table walks them all and the sentinel would-have-touched mass
    multiplies by this count. A mismatch raises."""
    t = None
    src = None
    for n in sorted(pools):
        tn = int(pools[n]["k_pages"].shape[1])
        if t is None:
            t, src = tn, f"pool {n!r}"
        elif tn != t:
            raise ValueError(
                f"mixed page_tokens in fused launch: {src} has {t} "
                f"tokens/page but pool {n!r} has {tn} — every pool and the "
                f"host sentinels must share one page size (deploy unequal "
                f"page sizes as separate caches)"
            )
    if host is not None:
        ht = int(host["page_tokens"])
        if t is None:
            t = ht
        elif ht != t:
            raise ValueError(
                f"mixed page_tokens in fused launch: {src} has {t} "
                f"tokens/page but host sentinels declare {ht} — sentinel "
                f"would-have-touched mass would be mis-scaled"
            )
    return 1 if t is None else t


def _tier_col(table, n_rows, code):
    """Tier-code column for one table: entries past the valid prefix become
    ``TIER_INVALID``. The single enforcement point that keeps stale
    ``(slot, tier_code)`` rows — including rows whose slot would alias row 0
    of an empty codec class's dummy buffer — out of the fused kernel."""
    mp = table.shape[1]
    valid = torch.arange(mp, dtype=torch.int32, device=table.device)[None] < n_rows[:, None]
    return torch.where(valid, code, TIER_INVALID).to(torch.int32)


def _class_operands(sel, t, kv, dummy_dtype, last_dim, device):
    """One codec class's kernel operands + per-pool global-row offsets.

    Class-major layout (all same-class pools alias ONE buffer — checked by
    tensor object identity): the shared buffer passes straight through with
    zero offsets and zero copies. A single standalone pool is copy-free too.
    Several standalone buffers concatenate, and the copied bytes count in
    ``_COPY_BYTES``. Mixing shared and standalone buffers within a class is
    ambiguous (offsets would double-count pages) and raises. An empty class
    gets a 1-row dummy buffer that ``TIER_INVALID`` masking never reads."""
    global _COPY_BYTES
    if not sel:
        pay = torch.zeros((1, t, kv, last_dim), dtype=dummy_dtype, device=device)
        sc = torch.ones((1, t, kv), dtype=torch.float32, device=device)
        return (pay, sc, pay, sc), []
    first = sel[0]
    if all(all(p[k] is first[k] for k in _CLASS_KEYS) for p in sel):
        return tuple(first[k] for k in _CLASS_KEYS), [0] * len(sel)
    for i in range(len(sel)):
        for j in range(i + 1, len(sel)):
            if any(sel[i][k] is sel[j][k] for k in _CLASS_KEYS):
                raise ValueError(
                    "same-class pools mix shared and standalone payload "
                    "buffers; either every pool of a codec class aliases "
                    "one class buffer (class-major layout) or none do"
                )
    offs, off = [], 0
    for p in sel:
        offs.append(off)
        off += int(p["k_pages"].shape[0])
    cat = tuple(torch.cat([p[k] for p in sel]) for k in _CLASS_KEYS)
    _COPY_BYTES += sum(a.numel() * a.element_size() for a in cat)
    return cat, offs


def _check_class_bounds(uni_slot, uni_tier, rows8: int, rows4: int) -> None:
    """Every VALID unified-table row must address a real class-buffer row
    (the kernel trusts the table). Stale rows are already ``TIER_INVALID``
    (see ``_tier_col``) and exempt."""
    slot = uni_slot.cpu()
    tier = uni_tier.cpu()
    for code, rows, cls in ((TIER_INT8, rows8, "int8"), (TIER_INT4, rows4, "int4")):
        sel = tier == code
        if bool(sel.any()):
            s = slot[sel]
            if int(s.min()) < 0 or int(s.max()) >= rows:
                raise IndexError(
                    f"unified table addresses {cls} class row "
                    f"{int(s.min())}..{int(s.max())} outside the class "
                    f"buffer's {rows} rows (stale slot with a live tier code?)"
                )


def _unified_operands(q, pools, recent_k, host):
    """Assemble the fused kernel's operands from N tier pools: two
    codec-class payload buffers plus the unified page table. Returns the
    kernel operands plus the {name: (col_lo, col_hi)} slot layout used to
    slice per-pool hotness back out of the unified mass."""
    b = q.shape[0]
    hd = q.shape[-1]
    kv = recent_k.shape[2]
    dev = q.device
    names = sorted(pools)
    t = _validated_page_tokens(pools, host)

    by_bits = {
        bits: [n for n in names if int(pools[n]["bits"]) == bits] for bits in (8, 4)
    }
    ops8, offs8 = _class_operands([pools[n] for n in by_bits[8]], t, kv, torch.int8, hd, dev)
    ops4, offs4 = _class_operands(
        [pools[n] for n in by_bits[4]], t, kv, torch.uint8, hd // 2, dev
    )
    base = dict(zip(by_bits[8], offs8))
    base.update(zip(by_bits[4], offs4))

    slot_cols, tier_cols = [], []
    layout: Dict[str, Tuple[int, int]] = {}
    col = 0
    for n in names:
        p = pools[n]
        mp = p["page_table"].shape[1]
        code = TIER_INT8 if int(p["bits"]) == 8 else TIER_INT4
        slot_cols.append(p["page_table"].to(torch.int32) + base[n])
        tier_cols.append(_tier_col(p["page_table"], p["n_pages"], code))
        layout[n] = (col, col + mp)
        col += mp
    if host is not None:
        mp = host["table"].shape[1]
        slot_cols.append(host["table"].to(torch.int32))
        tier_cols.append(_tier_col(host["table"], host["n"], TIER_HOST))
        layout["host"] = (col, col + mp)
        col += mp
        summary = host["summary"].to(torch.float32)
    else:
        summary = torch.zeros((1, kv, hd), dtype=torch.float32, device=dev)

    if col == 0:  # no pools, no host rows: recent-window-only launch
        uni_slot = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        uni_tier = torch.full((b, 1), TIER_INVALID, dtype=torch.int32, device=dev)
    else:
        uni_slot = torch.cat(slot_cols, dim=1).contiguous()
        uni_tier = torch.cat(tier_cols, dim=1).contiguous()

    k8, s8k, v8, s8v = ops8
    k4, s4k, v4, s4v = ops4
    _check_class_bounds(uni_slot, uni_tier, int(k8.shape[0]), int(k4.shape[0]))
    return (k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, uni_slot, uni_tier, t, layout)


def _fused_path(q, pools, recent_k, recent_v, recent_len, host, with_telemetry):
    b = q.shape[0]
    rlen = torch.as_tensor(recent_len, dtype=torch.int32, device=q.device).expand(b).contiguous()
    (k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary,
     uni_slot, uni_tier, t, layout) = _unified_operands(q, pools, recent_k, host)
    # ``t`` is the launch's single validated page-tokens value.
    out, m, lsum, mass, base = fused_attn_kernel(
        q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary,
        recent_k, recent_v, uni_slot, uni_tier, rlen, page_tokens=t,
    )
    if not with_telemetry:
        return out
    hot = {
        name: page_hotness(mass[:, lo:hi], base[:, lo:hi], m, lsum)
        for name, (lo, hi) in layout.items()
    }
    return out, hot


def tiered_decode_attention(
    q: torch.Tensor,  # [B, H, hd]
    pools: Dict[str, Dict[str, torch.Tensor]],
    recent_k: torch.Tensor,  # [B, R, KV, hd]
    recent_v: torch.Tensor,
    recent_len,
    cfg=None,
    with_telemetry: bool = False,
    host: Optional[Dict[str, torch.Tensor]] = None,
):
    """Attention over tiered compressed KV pools + dense recent window, in
    one fused launch.

    Returns out [B, H, hd] f32; with_telemetry=True also returns
    {tier: normalized page hotness [B, MP]}. When ``host`` is given (dict
    with ``summary`` [Hs, KV, hd], ``table`` [B, MPh], ``n`` [B],
    ``page_tokens``), the hotness dict also carries "host": the normalized
    would-have-touched mass of host-resident pages."""
    return _fused_path(q, pools, recent_k, recent_v, recent_len, host, with_telemetry)


def page_hotness(mass, base, m_tot, l_tot):
    """Rebase per-page local-max masses to the merged global softmax.

    Heads were collapsed in the mass telemetry; normalize by the summed
    head partition function at the global max base."""
    mref = m_tot.amax(dim=-1)
    z = (l_tot * torch.exp(m_tot - mref[:, None])).sum(dim=-1)
    return mass * torch.exp(base - mref[:, None]) / torch.clamp(z[:, None], min=1e-30)
