"""Memory-TCO model — Eq. 9-12 of the paper, evaluated live.

All functions take a placement vector (region -> placement index, 0 = DRAM/
HBM uncompressed, 1..N = compressed tiers) plus per-region sizes, and price
the configuration with the TierSet's cost model. ``measured_ratios`` lets the
caller substitute live-measured compressibility for the nominal ratios — the
paper's analytical model consumes measured per-tier compressibility the same
way (§7.4: the model sees deflate achieving only 2x on Memcached).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import hw
from repro_torch.core.tiers import TierSet


def usd_per_region(
    tierset: TierSet,
    region_bytes: int,
    measured_ratios: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """USD cost of holding one region in each placement index. Shape (N+1,).

    cost(0)   = region_bytes * USD_hbm                       (Eq. 9 per page)
    cost(y>0) = region_bytes * (1/C_Ty) * USD_media(Ty)      (Eq. 12 term)
    """
    out = np.empty(tierset.n_tiers + 1, dtype=np.float64)
    out[0] = region_bytes * hw.COSTS.usd_per_byte("hbm")
    for y, t in enumerate(tierset.tiers, start=1):
        if measured_ratios is not None and measured_ratios[y - 1] > 0:
            ratio = measured_ratios[y - 1]
        else:
            ratio = t.effective_ratio(tierset.block_elems, tierset.src_bytes_per_elem)
        out[y] = region_bytes * (1.0 / ratio) * hw.COSTS.usd_per_byte(t.media)
    return out


def tco_max(n_regions: int, region_bytes: int) -> float:
    """Eq. 9: everything uncompressed in DRAM/HBM."""
    return n_regions * region_bytes * hw.COSTS.usd_per_byte("hbm")


def tco_min(
    tierset: TierSet,
    n_regions: int,
    region_bytes: int,
    measured_ratios: Optional[Sequence[float]] = None,
) -> float:
    """Eq. 10: everything in the best-TCO tier (min over tiers, to be safe)."""
    costs = usd_per_region(tierset, region_bytes, measured_ratios)
    return n_regions * float(costs[1:].min())


def tco_nt(
    tierset: TierSet,
    placement: np.ndarray,
    region_bytes: int,
    measured_ratios: Optional[Sequence[float]] = None,
) -> float:
    """Eq. 12: cost of the current placement."""
    costs = usd_per_region(tierset, region_bytes, measured_ratios)
    return float(costs[placement].sum())


def savings_pct(
    tierset: TierSet,
    placement: np.ndarray,
    region_bytes: int,
    measured_ratios: Optional[Sequence[float]] = None,
) -> float:
    """Memory-TCO savings relative to all-DRAM, in percent (paper's metric).

    An empty placement (zero-region tenant) has nothing to save: 0.0, not a
    division by zero.
    """
    mx = tco_max(len(placement), region_bytes)
    if mx <= 0.0:
        return 0.0
    return 100.0 * (mx - tco_nt(tierset, placement, region_bytes, measured_ratios)) / mx


def budget(
    tierset: TierSet,
    n_regions: int,
    region_bytes: int,
    alpha: float,
    measured_ratios: Optional[Sequence[float]] = None,
) -> float:
    """Eq. 2's constraint bound: TCO_min + alpha * MTS  (MTS = Eq. 1)."""
    mx = tco_max(n_regions, region_bytes)
    mn = tco_min(tierset, n_regions, region_bytes, measured_ratios)
    return mn + alpha * (mx - mn)


# ---------------------------------------------------------------------------
# Fleet-level aggregation (multi-tenant: N managers share the substrate)
# ---------------------------------------------------------------------------


def fleet_tco_usd(managers: Sequence) -> float:
    """Aggregate memory TCO across tenant managers (Eq. 12 summed).

    An empty manager sequence is an empty fleet: 0.0.
    """
    return float(sum(
        tco_nt(m.tierset, m.placement, m.region_bytes, m.measured_ratios)
        for m in managers
    ))


def fleet_savings_pct(managers: Sequence) -> float:
    """Fleet TCO savings vs all-DRAM, weighted by each tenant's footprint.

    An empty fleet — no managers, or only zero-region tenants — saves
    nothing: 0.0, not a division by zero.
    """
    managers = list(managers)
    mx = sum(tco_max(m.n_regions, m.region_bytes) for m in managers)
    if mx <= 0.0:
        return 0.0
    return 100.0 * (mx - fleet_tco_usd(managers)) / mx
