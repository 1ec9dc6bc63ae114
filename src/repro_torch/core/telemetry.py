"""Hotness telemetry — the PEBS/TS-Daemon analogue (paper §6.2).

The paper samples MEM_INST_RETIRED.{ALL_LOADS,ALL_STORES} with PEBS and
accumulates counts into 2MB regions per 120s profile window. On TPU there is
no load/store sampling, but the computation itself yields *exact* access
counts:

  * KV-cache blocks: attention mass per block (sum of softmax weights), or
    simply blocks touched per decode step,
  * embedding rows: token-frequency histogram of the batch,
  * optimizer slices: per-slice gradient mass.

Exact telemetry is *better* than PEBS; to reproduce the paper's robustness
claims (waterfall tolerating profiling inaccuracies, §5.1) we also provide a
PEBS-fidelity mode that Bernoulli-thins and mis-attributes a fraction of the
exact counts.

All state is numpy on the host — telemetry is daemon-side (TS-Daemon runs on
host cores in the paper too), and its cost is accounted by the daemon-tax
benchmark.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PEBSNoise:
    """Emulate hardware-sampling fidelity loss on exact counts."""

    sample_rate: float = 0.05  # fraction of accesses that produce a sample
    misattribution: float = 0.01  # fraction of samples landing on a neighbour
    seed: int = 0

    def apply(self, counts: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        sampled = rng.binomial(counts.astype(np.int64), self.sample_rate)
        if self.misattribution > 0 and counts.size > 1:
            moved = rng.binomial(sampled, self.misattribution)
            sampled = sampled - moved
            # Mis-attributed samples land on a random neighbouring region.
            shift = np.roll(moved, 1)
            sampled = sampled + shift
        return sampled.astype(np.float64) / max(self.sample_rate, 1e-9)


@dataclasses.dataclass
class RegionTelemetry:
    """Per-region hotness over a sliding history of profile windows.

    ``hotness`` is the access count of the last closed window; ``history``
    keeps the last ``history_len`` windows so the analytical model can use the
    4-window average the paper feeds it (§7.1).
    """

    n_regions: int
    history_len: int = 4
    pebs: Optional[PEBSNoise] = None
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._accum = np.zeros(self.n_regions, dtype=np.float64)
        self.history = np.zeros((self.history_len, self.n_regions), dtype=np.float64)
        self._windows_closed = 0

    # -- ingest -------------------------------------------------------------
    def record(self, counts: np.ndarray) -> None:
        """Accumulate access counts (one engine step / sub-window)."""
        assert counts.shape == (self.n_regions,)
        self._accum += counts

    def record_indices(self, idx: np.ndarray, weights: Optional[np.ndarray] = None) -> None:
        np.add.at(self._accum, idx, 1.0 if weights is None else weights)

    # -- window boundary ------------------------------------------------------
    def close_window(self) -> np.ndarray:
        """End the profile window; returns the (possibly noised) hotness."""
        counts = self._accum
        if self.pebs is not None:
            counts = self.pebs.apply(counts, self._rng)
        self.history = np.roll(self.history, 1, axis=0)
        self.history[0] = counts
        self._accum = np.zeros_like(self._accum)
        self._windows_closed += 1
        return self.history[0].copy()

    # -- views ----------------------------------------------------------------
    @property
    def hotness(self) -> np.ndarray:
        """Last closed window's hotness."""
        return self.history[0]

    def averaged_hotness(self, windows: int = 4) -> np.ndarray:
        """Mean hotness over the last ``windows`` closed windows (paper §7.1)."""
        w = min(windows, max(self._windows_closed, 1), self.history_len)
        return self.history[:w].mean(axis=0)

    def percentile_threshold(self, pct: float) -> float:
        """Hotness value below which ``pct`` fraction of regions fall.

        Used to derive the paper's conservative/moderate/aggressive H_th
        values (cover ~20%/50%/80% of data, §7.1).
        """
        return float(np.quantile(self.hotness, pct))
