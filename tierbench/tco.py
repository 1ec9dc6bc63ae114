"""Memory TCO of a KV placement: a frozen copy of the cost arithmetic of the
port's ``core/tco.py`` and ``core/tiers.py`` (Eq. 9 and 12 of the paper)
and of its unit costs (``core/hw.py``), with the tiers' nominal ratios.

A page of ``page_elems`` bf16 elements (K and V) costs, in placement level

    0 (uncompressed HBM):      src_bytes * USD(hbm)
    y (a compressed tier):     stored_bytes(tier) * USD(tier's media)

where ``stored_bytes`` follows the tier's pool: ``slab`` (zbud analogue,
half-page slots at 85% fill, scales beside) or ``packed`` (zsmalloc
analogue, 128-byte aligned, an 8-byte index entry). The savings over a set
of placements is ``100 * (1 - sum cost / sum cost at level 0)``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

USD_PER_GIB = {"hbm": 10.0, "host": 10.0 / 3.0}
SLAB_UTILIZATION = 0.85
PACKED_ALIGN = 128
PACKED_INDEX_BYTES = 8
GROUP = {8: 128, 4: 64}  # elements per f32 scale of the int8 / int4 codecs
SCALE_BYTES = 4

# (pool, bits, media) of the characterized tiers the KV cache binds.
TIERS: Dict[str, Tuple[str, int, str]] = {
    "C5": ("slab", 8, "hbm"),
    "C6": ("packed", 8, "hbm"),
    "C7": ("packed", 8, "host"),
    "C8": ("slab", 4, "hbm"),
    "C9": ("packed", 4, "hbm"),
    "C10": ("packed", 4, "host"),
}
DEVICE_TIER = {("warm", 8): "C5", ("warm", 4): "C8", ("cold", 8): "C6", ("cold", 4): "C9"}


def stored_bytes(tier: str, n_elem: int) -> int:
    pool, bits, _ = TIERS[tier]
    payload = n_elem * bits // 8
    scales = math.ceil(n_elem / GROUP[bits]) * SCALE_BYTES
    if pool == "slab":
        slot = max(n_elem * 2 // 2, 1)
        return int(math.ceil(payload / slot) * slot / SLAB_UTILIZATION) + scales
    return math.ceil((payload + scales) / PACKED_ALIGN) * PACKED_ALIGN + PACKED_INDEX_BYTES


def level_tiers(warm_bits: int, cold_bits: int) -> Tuple[str, str, str, str]:
    """Tiers of placement levels 1..4: warm, cold, host int8, host int4."""
    return (DEVICE_TIER[("warm", warm_bits)], DEVICE_TIER[("cold", cold_bits)], "C7", "C10")


def level_costs(page_elems: int, warm_bits: int = 8, cold_bits: int = 4) -> np.ndarray:
    """USD of one page in placement levels 0..4."""
    gib = float(1 << 30)
    out = [page_elems * 2 * USD_PER_GIB["hbm"] / gib]
    for t in level_tiers(warm_bits, cold_bits):
        out.append(stored_bytes(t, page_elems) * USD_PER_GIB[TIERS[t][2]] / gib)
    return np.array(out)


def placement_cost(levels: np.ndarray, costs: np.ndarray) -> Tuple[float, float]:
    """(cost of the placement, cost of the same pages uncompressed in HBM)
    for the pages of ``levels`` (each in 0..4)."""
    counts = np.bincount(np.asarray(levels, np.int64), minlength=costs.size)
    return float(counts @ costs), float(counts.sum() * costs[0])


def savings_pct(cost: float, cost_max: float) -> float:
    return 100.0 * (1.0 - cost / cost_max)
