"""Waterfall placement model (paper §5.1).

At the end of every profile window:
  * regions faulted back during the window restart from DRAM (index 0),
  * DRAM regions with hotness < H_th are pushed to tier 1,
  * every compressed region that was NOT accessed ages one tier down
    (T_k -> T_{k+1}), except the last tier.

The model is fully vectorized; its cost is part of the daemon tax.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WaterfallConfig:
    hotness_threshold: float  # H_th: DRAM regions colder than this are evicted
    # A region whose faulted-back fraction exceeds this within the window
    # "restarts its journey from DRAM" (paper §6.3: "a major portion").
    refault_fraction: float = 0.25


def waterfall_step(
    placement: np.ndarray,
    hotness: np.ndarray,
    fault_fraction: np.ndarray,
    n_tiers: int,
    cfg: WaterfallConfig,
) -> np.ndarray:
    """One end-of-window placement update. Returns the new placement vector.

    Args:
      placement: (R,) int, 0 = DRAM, 1..n_tiers = compressed tier index.
      hotness:   (R,) float, access counts of the closed window.
      fault_fraction: (R,) float in [0,1], fraction of the region's blocks
        faulted back to DRAM during the window.
      n_tiers:   number of compressed tiers N.
      cfg:       thresholds.
    """
    placement = placement.copy()
    in_dram = placement == 0
    compressed = ~in_dram

    # Faulted regions restart from DRAM.
    refaulted = compressed & (fault_fraction >= cfg.refault_fraction)
    placement[refaulted] = 0

    # Untouched compressed regions age one tier down (waterfall).
    untouched = compressed & (hotness <= 0) & ~refaulted
    placement[untouched] = np.minimum(placement[untouched] + 1, n_tiers)

    # Cold DRAM regions are evicted to tier 1.
    evict = in_dram & (hotness < cfg.hotness_threshold)
    placement[evict] = 1
    return placement
