"""Trace-driven window simulator — the evaluation substrate for §7.

Drives a TierScapeManager with synthetic region-access traces that mirror the
paper's workloads (Table 3):

  * ``gaussian_kv``  — Memcached/Redis analogue: memtier-style Gaussian key
    popularity with slow center drift,
  * ``rotating_frontier`` — BFS/PageRank analogue: a hot frontier that sweeps
    the graph between windows,
  * ``uniform_scan`` — XSBench analogue: huge footprint, near-uniform random
    lookups.

Per window the simulator
  1. draws ground-truth access counts per region,
  2. charges faults: first access to a compressed region pays the tier's
     access latency (Eq. 3-5) and returns the region to DRAM,
  3. feeds (possibly PEBS-noised) counts to the manager,
  4. runs the placement model and executes the migration plan,
  5. records performance overhead, TCO, latency distribution and daemon tax.

Performance metric: relative slowdown = fault_overhead / base_runtime per
window, where base_runtime = accesses * DRAM service time + workload compute
time — matching the paper's "perf w.r.t. all-DRAM" axis in Fig. 8.

A copy of ``repro.core.simulator`` that stays numpy on the host: the same
float64 arithmetic, RNG streams (``default_rng(seed)``, and
``default_rng(seed + 17 * t)`` per tenant) and stable sorts, so the same
workloads on the same seed give results equal to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, List

import numpy as np

from repro_torch.core.manager import TierScapeManager

if TYPE_CHECKING:  # runtime import is deferred: repro_torch.media imports
    from repro_torch.media.devices import MediaQueue  # repro_torch.core (hw)

# Service time for an access that hits uncompressed HBM/DRAM (block-granular
# engine access, not a single cache line).
DRAM_ACCESS_US = 0.5


@dataclasses.dataclass
class Workload:
    name: str
    n_regions: int
    accesses_per_window: int
    # compute seconds per window spent off the memory path (so slowdown
    # percentages land in a realistic range, like the paper's benchmarks).
    compute_s_per_window: float
    sampler: Callable[[int, np.random.Generator], np.ndarray]
    # Observed line-compression ratio of this tenant's data on
    # inline-compressed media (nominal bytes / wire bytes, in [1, 2] for the
    # cxl_hw line codec). 1.0 = incompressible. Benchmarks measure this from
    # real encoded payloads (codecs.cxl_line_ratio) and bake it into the
    # workload; the simulator feeds it to the adaptive devices and managers
    # at window boundaries only.
    line_ratio: float = 1.0

    def sample_window(self, w: int, rng: np.random.Generator) -> np.ndarray:
        counts = self.sampler(w, rng)
        assert counts.shape == (self.n_regions,)
        return counts


def gaussian_kv(
    n_regions: int = 4096,
    accesses_per_window: int = 2_000_000,
    sigma_frac: float = 0.08,
    drift_frac: float = 0.01,
    compute_s_per_window: float = 1.0,
    name: str = "memcached",
) -> Workload:
    def sampler(w: int, rng: np.random.Generator) -> np.ndarray:
        center = (0.5 + drift_frac * w) % 1.0
        keys = rng.normal(center, sigma_frac, size=accesses_per_window)
        idx = (np.mod(keys, 1.0) * n_regions).astype(np.int64)
        return np.bincount(idx, minlength=n_regions).astype(np.float64)

    return Workload(name, n_regions, accesses_per_window, compute_s_per_window, sampler)


def rotating_frontier(
    n_regions: int = 4096,
    accesses_per_window: int = 2_000_000,
    frontier_frac: float = 0.15,
    advance_frac: float = 0.05,
    background_frac: float = 0.10,
    compute_s_per_window: float = 1.0,
    name: str = "bfs",
) -> Workload:
    def sampler(w: int, rng: np.random.Generator) -> np.ndarray:
        start = int(w * advance_frac * n_regions) % n_regions
        width = max(int(frontier_frac * n_regions), 1)
        hot = (start + rng.integers(0, width, size=int(accesses_per_window * (1 - background_frac)))) % n_regions
        bg = rng.integers(0, n_regions, size=int(accesses_per_window * background_frac))
        idx = np.concatenate([hot, bg])
        return np.bincount(idx, minlength=n_regions).astype(np.float64)

    return Workload(name, n_regions, accesses_per_window, compute_s_per_window, sampler)


def uniform_scan(
    n_regions: int = 16384,
    accesses_per_window: int = 2_000_000,
    compute_s_per_window: float = 2.0,
    name: str = "xsbench",
) -> Workload:
    def sampler(w: int, rng: np.random.Generator) -> np.ndarray:
        idx = rng.integers(0, n_regions, size=accesses_per_window)
        return np.bincount(idx, minlength=n_regions).astype(np.float64)

    return Workload(name, n_regions, accesses_per_window, compute_s_per_window, sampler)


def bursty_kv(
    n_regions: int = 4096,
    accesses_per_window: int = 2_000_000,
    burst_every: int = 8,
    burst_windows: int = 2,
    burst_mult: float = 6.0,
    sigma_frac: float = 0.10,
    compute_s_per_window: float = 1.0,
    name: str = "bursty",
) -> Workload:
    """Bursty tenant: Gaussian popularity whose traffic multiplies by
    ``burst_mult`` for ``burst_windows`` windows out of every ``burst_every``
    (flash-crowd analogue). The arbiter should hand it fast-tier budget
    during bursts and reclaim it between them."""

    def sampler(w: int, rng: np.random.Generator) -> np.ndarray:
        mult = burst_mult if (w % burst_every) < burst_windows else 1.0
        n_acc = int(accesses_per_window * mult)
        keys = rng.normal(0.5, sigma_frac, size=n_acc)
        idx = (np.mod(keys, 1.0) * n_regions).astype(np.int64)
        return np.bincount(idx, minlength=n_regions).astype(np.float64)

    return Workload(name, n_regions, accesses_per_window, compute_s_per_window, sampler)


def skew_flip(
    n_regions: int = 4096,
    accesses_hot: int = 2_000_000,
    accesses_cold: int = 200_000,
    flip_window: int = 20,
    hot_first: bool = True,
    sigma_frac: float = 0.08,
    compute_s_per_window: float = 1.0,
    name: str = "skewflip",
) -> Workload:
    """Skew-flip tenant: hot Gaussian traffic before ``flip_window``, near-idle
    uniform traffic after (or the reverse with ``hot_first=False``). Two such
    tenants with opposite phase model a mid-run skew flip between tenants."""

    def sampler(w: int, rng: np.random.Generator) -> np.ndarray:
        hot_phase = (w < flip_window) == hot_first
        if hot_phase:
            keys = rng.normal(0.5, sigma_frac, size=accesses_hot)
            idx = (np.mod(keys, 1.0) * n_regions).astype(np.int64)
        else:
            idx = rng.integers(0, n_regions, size=accesses_cold)
        return np.bincount(idx, minlength=n_regions).astype(np.float64)

    return Workload(name, n_regions, max(accesses_hot, accesses_cold),
                    compute_s_per_window, sampler)


PAPER_WORKLOADS: Callable[[], List[Workload]] = lambda: [
    gaussian_kv(name="memcached", sigma_frac=0.08),
    gaussian_kv(name="redis", sigma_frac=0.12, drift_frac=0.02),
    rotating_frontier(name="bfs", advance_frac=0.08),
    rotating_frontier(name="pagerank", advance_frac=0.02, frontier_frac=0.25),
    uniform_scan(name="xsbench"),
]


@dataclasses.dataclass
class SimResult:
    workload: str
    config: str
    windows: int
    slowdown_pct: float  # mean relative slowdown vs all-DRAM
    tco_savings_pct: float  # mean memory TCO savings
    mean_access_us: float
    p99_access_us: float
    daemon_tax_pct: float  # daemon time / total runtime
    mean_migrations_per_window: float
    mean_cohorts_per_window: float  # batched executor: dispatches per window
    # Backing-media replay: migration traffic queued through each device's
    # bandwidth/queue-depth model over the whole run.
    media_bytes_by_device: Dict[str, int]
    media_busy_s_by_device: Dict[str, float]
    media_queue_wait_s: float  # time plans spent waiting on busy channels
    per_window_savings: np.ndarray
    per_window_slowdown: np.ndarray
    placement_hists: np.ndarray  # (W, N+1)
    fault_hists: np.ndarray  # (W, N+1) faults per source placement
    # Speculative prefetch replay (``simulate(prefetch=True)``): regions
    # staged ahead that were / were not touched next window, and the
    # speculative bytes billed to the media queues (mispredictions included).
    prefetch_hits: int = 0
    prefetch_misses: int = 0
    prefetch_bytes: int = 0


def charge_window_faults(
    manager: TierScapeManager, counts: np.ndarray, free_mask=None
) -> tuple[float, np.ndarray, np.ndarray]:
    """Ground-truth fault accounting for one window (engine side).

    A compressed region accessed k times faults its distinct blocks on
    demand: E[distinct blocks among k uniform accesses of B blocks] =
    B * (1 - (1 - 1/B)^k)  (4KB-page faults within the 2MB region).
    Returns (fault_overhead_s, per-placement fault histogram, n_blocks).

    ``free_mask`` marks regions whose fault *latency* was hidden (their
    swap-in was prefetched ahead of the first touch): every piece of fault
    bookkeeping — counts, histogram, the refault move back to DRAM — runs
    identically to a prefetch-free window, so placement trajectories and
    migration billing never diverge; only the stall is refunded.
    """
    bpr = manager.blocks_per_region
    placement_before = manager.placement.copy()
    faulted = (counts > 0) & (placement_before > 0)
    fault_ids = np.where(faulted)[0]
    k = counts[fault_ids]
    n_blocks = bpr * (1.0 - (1.0 - 1.0 / bpr) ** k)
    fault_src = placement_before[fault_ids]
    fault_lat_s = manager.fault_back(fault_ids, n_blocks)
    fault_hist = np.zeros(manager.tierset.n_tiers + 1)
    np.add.at(fault_hist, fault_src, n_blocks)
    overhead = float(fault_lat_s.sum())
    if free_mask is not None:
        hidden = float(fault_lat_s[free_mask[fault_ids]].sum())
        manager.discount_fault_overhead(hidden)
        overhead -= hidden
    return overhead, fault_hist, n_blocks


def replay_plan_media(
    manager: TierScapeManager,
    queues: Dict[str, MediaQueue],
    now_s: float,
    price_contention: bool = False,
    window_s: float = 1.0,
) -> None:
    """Replay the last window's migration plan through the media queues.

    Each device's share of the plan (bytes billed by ``manager._plan``) is
    submitted at the window's virtual timestamp, so queue-depth contention
    across windows (and across tenants sharing ``queues``) accumulates in
    ``busy_s``/``queue_wait_s`` deterministically. ``price_contention``
    additionally feeds the executed busy time back into the manager so the
    next window's placement prices the contention.
    """
    ws = manager.history[-1]
    for name, n_bytes in ws.media_bytes_by_device.items():
        queues[name].submit(n_bytes, now=now_s, ops=max(ws.migration_cohorts, 1))
    if price_contention:
        manager.note_media_charges(ws.media_s_by_device, window_s)


def _feed_adaptive_media(managers, workloads, media_queues) -> None:
    """Window-boundary compressibility feedback for adaptive media devices.

    For every inline-compressed device in the shared queue set: observe each
    tenant's resident nominal-vs-wire bytes (weighted by what is actually
    placed there), fold the shared device EWMA once (``commit_window`` — the
    only point the effective bandwidth may move), and update each manager's
    own wire-ratio view plus the measured ratio of its tiers backed by that
    device (effective-capacity pricing in Eq. 9-12). Called strictly at
    window boundaries so in-window service times are replay-deterministic.
    """
    from repro_torch.media.devices import adaptive_devices

    adaptive = adaptive_devices(media_queues)
    if not adaptive:
        return
    for m, wl in zip(managers, workloads):
        ratio = max(float(getattr(wl, "line_ratio", 1.0)), 1.0)
        nominal_ratios = m.tierset.ratios()
        for i, dev in enumerate(m._dev_names):
            if dev not in adaptive:
                continue
            if m.history:
                resident = float(m.history[-1].placement_hist[i]) * float(
                    m._stored_bytes[i]
                )
                if resident > 0:
                    adaptive[dev].observe(resident, resident / ratio)
            m.note_media_ratio(dev, ratio)
            if i >= 1:
                m.update_measured_ratio(i, nominal_ratios[i] * ratio)
    for dev in adaptive.values():
        dev.commit_window()


def _prefetch_consume(staged: np.ndarray, counts: np.ndarray):
    """Window start: resolve last window's speculative staging against the
    ground-truth accesses. Clears ``staged`` and returns (free_mask for
    ``charge_window_faults`` — hits whose fault latency was hidden —
    n_hits, n_misses)."""
    hit = staged & (counts > 0)
    hits = int(hit.sum())
    misses = int((staged & ~hit).sum())
    staged[:] = False
    return hit, hits, misses


def _prefetch_stage(
    manager: TierScapeManager,
    staged: np.ndarray,
    media_queues: Dict[str, "MediaQueue"],
    now_s: float,
    max_regions: int,
) -> Dict[str, float]:
    """Mid-window (telemetry recorded, window not yet closed): flag warming
    compressed regions and bill their speculative reads to each region's
    backing device immediately — spent whether or not the prediction lands,
    so mispredictions cannot vanish from the report. The frontier is the
    current uncompressed (fast) set's size: a region qualifies when its
    projected hotness would rank it inside that set next window. Returns
    the per-device speculative bytes billed."""
    cand = manager.prefetch_candidates(
        manager.placement > 0,
        top_k=max(int((manager.placement == 0).sum()), 1),
        max_regions=max_regions,
    )
    out: Dict[str, float] = {}
    if cand.size:
        staged[cand] = True
        src = manager.placement[cand]
        for lvl in np.unique(src):
            sel = src == lvl
            nb = int(manager._stored_bytes[lvl]) * int(sel.sum())
            dev = manager._dev_names[lvl]
            media_queues[dev].submit(nb, now=now_s, ops=int(sel.sum()))
            out[dev] = out.get(dev, 0.0) + nb
    return out


def simulate(
    workload: Workload,
    manager: TierScapeManager,
    windows: int = 40,
    warmup_windows: int = 2,
    seed: int = 0,
    price_media_contention: bool = False,
    prefetch: bool = False,
    prefetch_max_regions: int = 64,
) -> SimResult:
    """``prefetch=True`` replays speculative readahead: mid-window, the
    warming-page predictor flags compressed regions and their speculative
    reads are billed to the media queues immediately (mispredictions
    included). A staged region touched next window pays no fault *latency*
    — the swap-in already happened — but every piece of fault bookkeeping
    runs unchanged, so placement trajectories, plans and migration billing
    are identical to a prefetch-free run; only the stall disappears and the
    speculative read traffic appears."""
    from repro_torch.media.devices import make_queues

    rng = np.random.default_rng(seed)
    n = workload.n_regions
    assert manager.n_regions == n
    # Backing-media replay: one queue per distinct device in the tierset.
    media_queues = make_queues(d.name for d in manager.tierset.media_devices())
    staged = np.zeros(n, bool)
    prefetch_hits = prefetch_misses = prefetch_bytes = 0

    slowdowns, savings = [], []
    placement_hists, fault_hists = [], []
    # Latency histogram support: DRAM hits + one bucket per placement index
    # (block-granular fault latency — the paper's per-page fault cost).
    blk_lat_us = np.array(manager.tierset.latencies_s()) * 1e6
    lat_support_us = np.concatenate([[DRAM_ACCESS_US], blk_lat_us[1:]])
    lat_counts = np.zeros_like(lat_support_us)

    for w in range(windows):
        counts = workload.sample_window(w, rng)
        free_mask = None
        if prefetch and staged.any():
            # A hit's swap-in was prefetched mid-window: its fault latency
            # is hidden, but all fault bookkeeping (and so the placement
            # trajectory and migration billing) stays bit-identical to a
            # prefetch-free run.
            free_mask, h, m_ = _prefetch_consume(staged, counts)
            prefetch_hits += h
            prefetch_misses += m_
        fault_overhead_s, fault_hist, n_blocks = charge_window_faults(
            manager, counts, free_mask=free_mask
        )

        # Latency distribution: each faulted block pays its tier's fault
        # latency; every other access is a DRAM hit.
        lat_counts[0] += counts.sum() - n_blocks.sum()
        lat_counts[1:] += fault_hist[1:]
        fault_hists.append(fault_hist)

        # --- telemetry + model ---------------------------------------------
        base_s = workload.compute_s_per_window + counts.sum() * DRAM_ACCESS_US * 1e-6
        manager.record_access_counts(counts)
        if prefetch:
            prefetch_bytes += int(sum(
                _prefetch_stage(
                    manager, staged, media_queues, w * base_s,
                    prefetch_max_regions,
                ).values()
            ))
        manager.end_window()

        replay_plan_media(
            manager, media_queues, now_s=w * base_s,
            price_contention=price_media_contention, window_s=base_s,
        )
        _feed_adaptive_media([manager], [workload], media_queues)
        if w >= warmup_windows:
            slowdowns.append(100.0 * fault_overhead_s / base_s)
            savings.append(manager.history[-1].savings_pct)
        placement_hists.append(manager.history[-1].placement_hist)

    # Percentiles from the latency histogram.
    order = np.argsort(lat_support_us)
    cdf = np.cumsum(lat_counts[order]) / max(lat_counts.sum(), 1)
    mean_us = float((lat_support_us * lat_counts).sum() / max(lat_counts.sum(), 1))
    p99_us = float(lat_support_us[order][np.searchsorted(cdf, 0.99)])

    total_base = windows * (
        workload.compute_s_per_window
        + workload.accesses_per_window * DRAM_ACCESS_US * 1e-6
    )
    return SimResult(
        workload=workload.name,
        config=f"{manager.cfg.policy}",
        windows=windows,
        slowdown_pct=float(np.mean(slowdowns)) if slowdowns else 0.0,
        tco_savings_pct=float(np.mean(savings)) if savings else 0.0,
        mean_access_us=mean_us,
        p99_access_us=p99_us,
        daemon_tax_pct=100.0 * manager.total_daemon_s / total_base,
        mean_migrations_per_window=float(
            np.mean([h.migrations for h in manager.history])
        ),
        mean_cohorts_per_window=float(
            np.mean([h.migration_cohorts for h in manager.history])
        ),
        media_bytes_by_device={
            n_: q.bytes_total for n_, q in media_queues.items() if q.ops
        },
        media_busy_s_by_device={
            n_: q.busy_s for n_, q in media_queues.items() if q.ops
        },
        media_queue_wait_s=float(
            sum(q.queue_wait_s for q in media_queues.values())
        ),
        per_window_savings=np.array(savings),
        per_window_slowdown=np.array(slowdowns),
        placement_hists=np.stack(placement_hists),
        fault_hists=np.stack(fault_hists),
        prefetch_hits=prefetch_hits,
        prefetch_misses=prefetch_misses,
        prefetch_bytes=prefetch_bytes,
    )


# ---------------------------------------------------------------------------
# Multi-tenant simulation: N workloads, one manager each, shared substrate
# under a BudgetArbiter (paper §8 direction).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TenantSimStats:
    tenant: str
    workload: str
    slowdown_pct: float  # mean relative slowdown vs all-DRAM (post-warmup)
    tco_savings_pct: float
    mean_fast_regions: float  # mean regions resident uncompressed
    mean_budget_usd: float  # mean arbiter-allotted budget
    # All per-window arrays cover the same post-warmup windows, aligned
    # index-for-index: shape (windows - warmup_windows,).
    per_window_fast: np.ndarray
    per_window_budget: np.ndarray
    per_window_savings: np.ndarray
    per_window_slowdown: np.ndarray


@dataclasses.dataclass
class MultiTenantSimResult:
    windows: int
    fleet_savings_pct: float  # mean aggregate TCO savings (post-warmup)
    fleet_tco_usd: float  # mean aggregate TCO (post-warmup, this run only)
    budget_feasible_frac: float  # this run's windows where floors fit the budget
    tenants: List["TenantSimStats"]
    per_window_fleet_savings: np.ndarray
    # Shared backing-media replay: all tenants' migration traffic queued
    # through ONE set of device queues (the contention the arbiter prices).
    media_bytes_by_device: Dict[str, int] = dataclasses.field(default_factory=dict)
    media_busy_s_by_device: Dict[str, float] = dataclasses.field(default_factory=dict)
    media_queue_wait_s: float = 0.0
    # Fleet-wide speculative prefetch replay (``prefetch=True``): the bytes
    # are also reported to the arbiter per window, consuming its per-device
    # bandwidth budgets before demand moves are considered.
    prefetch_hits: int = 0
    prefetch_misses: int = 0
    prefetch_bytes: int = 0


def simulate_multitenant(
    workloads: List[Workload],
    arbiter,
    windows: int = 40,
    warmup_windows: int = 2,
    seed: int = 0,
    prefetch: bool = False,
    prefetch_max_regions: int = 64,
) -> MultiTenantSimResult:
    """Drive N tenant workloads against one BudgetArbiter.

    Per window, each tenant samples its trace, charges faults against its own
    manager and records telemetry; the arbiter then closes every tenant's
    window at once — waterfilling budgets, reconciling shared-pool capacity
    and committing every placement.

    ``prefetch=True`` replays per-tenant speculative readahead with the same
    placement-neutral semantics as ``simulate``; the fleet's speculative
    bytes are additionally reported to the arbiter via
    ``record_speculative_bytes`` each window, so speculation consumes the
    shared per-device bandwidth budgets before demand moves are considered.
    """
    from repro_torch.media.devices import make_queues

    specs, managers = arbiter.specs, arbiter.managers
    assert len(workloads) == len(managers)
    for wl, m in zip(workloads, managers):
        assert m.n_regions == wl.n_regions
    rngs = [np.random.default_rng(seed + 17 * t) for t in range(len(workloads))]
    # One shared queue set: tenants contend for the same physical devices
    # (union across tiersets — tenants may bind tiers to different devices).
    media_queues = make_queues(
        d.name for m in managers for d in m.tierset.media_devices()
    )

    t_slow: List[List[float]] = [[] for _ in workloads]
    t_save: List[List[float]] = [[] for _ in workloads]
    t_fast: List[List[int]] = [[] for _ in workloads]
    t_budget: List[List[float]] = [[] for _ in workloads]
    fleet_save: List[float] = []
    staged = [np.zeros(wl.n_regions, bool) for wl in workloads]
    prefetch_hits = prefetch_misses = prefetch_bytes = 0

    for w in range(windows):
        overheads = []
        spec_bytes: Dict[str, float] = {}
        for t, (wl, m) in enumerate(zip(workloads, managers)):
            counts = wl.sample_window(w, rngs[t])
            free_mask = None
            if prefetch and staged[t].any():
                free_mask, h, m_ = _prefetch_consume(staged[t], counts)
                prefetch_hits += h
                prefetch_misses += m_
            fault_overhead_s, _, _ = charge_window_faults(
                m, counts, free_mask=free_mask
            )
            m.record_access_counts(counts)
            base_s = wl.compute_s_per_window + counts.sum() * DRAM_ACCESS_US * 1e-6
            overheads.append(100.0 * fault_overhead_s / base_s)
            if prefetch:
                for dev, nb in _prefetch_stage(
                    m, staged[t], media_queues, float(w), prefetch_max_regions
                ).items():
                    spec_bytes[dev] = spec_bytes.get(dev, 0.0) + nb
                    prefetch_bytes += int(nb)
        if spec_bytes:
            arbiter.record_speculative_bytes(spec_bytes)
        arbiter.end_window()
        for m in managers:
            replay_plan_media(m, media_queues, now_s=float(w))
        _feed_adaptive_media(managers, workloads, media_queues)
        ws = arbiter.history[-1]
        if w >= warmup_windows:
            fleet_save.append(ws.fleet_savings_pct)
            for t, ts in enumerate(ws.tenants):
                t_slow[t].append(overheads[t])
                t_save[t].append(ts.savings_pct)
                t_fast[t].append(ts.fast_regions)
                t_budget[t].append(ts.budget_usd)

    tenants = [
        TenantSimStats(
            tenant=specs[t].name,
            workload=workloads[t].name,
            slowdown_pct=float(np.mean(t_slow[t])) if t_slow[t] else 0.0,
            tco_savings_pct=float(np.mean(t_save[t])) if t_save[t] else 0.0,
            mean_fast_regions=float(np.mean(t_fast[t])) if t_fast[t] else 0.0,
            mean_budget_usd=float(np.mean(t_budget[t])) if t_budget[t] else 0.0,
            per_window_fast=np.array(t_fast[t], dtype=np.float64),
            per_window_budget=np.array(t_budget[t]),
            per_window_savings=np.array(t_save[t]),
            per_window_slowdown=np.array(t_slow[t]),
        )
        for t in range(len(workloads))
    ]
    return MultiTenantSimResult(
        windows=windows,
        fleet_savings_pct=float(np.mean(fleet_save)) if fleet_save else 0.0,
        # Restrict aggregates to THIS run's windows (the arbiter may carry
        # history from earlier runs), with the same warmup cut as savings.
        fleet_tco_usd=float(np.mean(
            [h.fleet_tco_usd for h in arbiter.history[-windows:][warmup_windows:]]
        )) if windows > warmup_windows else 0.0,
        budget_feasible_frac=float(np.mean(
            [h.budget_feasible for h in arbiter.history[-windows:]]
        )),
        tenants=tenants,
        per_window_fleet_savings=np.array(fleet_save),
        media_bytes_by_device={
            n_: q.bytes_total for n_, q in media_queues.items() if q.ops
        },
        media_busy_s_by_device={
            n_: q.busy_s for n_, q in media_queues.items() if q.ops
        },
        media_queue_wait_s=float(sum(q.queue_wait_s for q in media_queues.values())),
        prefetch_hits=prefetch_hits,
        prefetch_misses=prefetch_misses,
        prefetch_bytes=prefetch_bytes,
    )


def simulate_single_tenant_baseline(
    workloads: List[Workload],
    manager: TierScapeManager,
    windows: int = 40,
    warmup_windows: int = 2,
    seed: int = 0,
) -> float:
    """Mean post-warmup TCO savings of ONE manager over the concatenated
    region space of all workloads — the no-tenant-split reference that
    ``simulate_multitenant`` results are compared against. Uses the same
    per-tenant trace streams (``default_rng(seed + 17*t)``) so the two runs
    see identical ground-truth accesses.
    """
    assert manager.n_regions == sum(wl.n_regions for wl in workloads)
    rngs = [np.random.default_rng(seed + 17 * t) for t in range(len(workloads))]
    saves = []
    for w in range(windows):
        counts = np.concatenate(
            [wl.sample_window(w, rngs[t]) for t, wl in enumerate(workloads)]
        )
        charge_window_faults(manager, counts)
        manager.record_access_counts(counts)
        manager.end_window()
        if w >= warmup_windows:
            saves.append(manager.history[-1].savings_pct)
    return float(np.mean(saves)) if saves else 0.0
