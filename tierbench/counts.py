"""Bytes of the cache's work, from the attention shape and the cache's page
counts: the numerators of the kernels' roofline metrics and the cache's
share of a decode step's. ``m`` is a ``families.Shape`` (the model's own
operations and bytes are its family module's).

Every input byte is counted once and every output byte once, whatever a
kernel reads again; attention counts only the pages, rows and slots that
hold live tokens."""

from __future__ import annotations

import numpy as np

BF16, F32, I32 = 2, 4, 4


def page_bytes(m, pt: int, bits: int) -> int:
    """Payload and f32 scales of one page (K and V) at ``bits``."""
    return 2 * pt * m.kv * (m.hd * bits // 8 + F32)


def attention_step_bytes(m, pt: int, warm_bits: int, cold_bits: int,
                         n_warm: np.ndarray, n_cold: np.ndarray, n_host: np.ndarray,
                         recent: np.ndarray) -> int:
    """Bytes the fused tiered attention kernel needs over all layers of one
    step, for the active slots: ``n_warm``, ``n_cold``, ``n_host`` [layers,
    slots] page counts, ``recent`` [slots] live recent-window rows (the new
    token included). In: q (bf16), the device pages with scales, the host
    sentinel centroids (f32), the recent rows (bf16 K and V), the unified
    page table (slot and tier, int32) and the window lengths. Out: the
    output (f32), m and l (f32), the page mass and base (f32) of each live
    row."""
    slots = recent.size
    rows = n_warm + n_cold + n_host
    per_layer_in = (slots * m.heads * m.hd * BF16 + slots * I32
                    + 2 * (recent.sum() * m.kv * m.hd * BF16))
    total = m.layers * per_layer_in
    total += int(n_warm.sum()) * page_bytes(m, pt, warm_bits)
    total += int(n_cold.sum()) * page_bytes(m, pt, cold_bits)
    total += int(n_host.sum()) * m.kv * m.hd * F32
    total += int(rows.sum()) * 2 * I32
    total += m.layers * slots * (m.heads * m.hd * F32 + 2 * m.heads * F32)
    total += int(rows.sum()) * 2 * F32
    return int(total)


def quant_bytes(m, pt: int, pages: int, bits: int) -> int:
    """Bytes of the page-out quantization of ``pages`` pages (K and V): bf16
    in, codes and f32 scales out."""
    return pages * 2 * pt * m.kv * m.hd * BF16 + pages * page_bytes(m, pt, bits)
