"""TierScapeManager — the TS-Daemon analogue (paper §6.2-6.3).

Host-side controller owning:
  * the TierSet (DRAM/HBM + N software-defined compressed tiers),
  * per-region telemetry (exact or PEBS-emulated),
  * the placement vector,
  * the placement policy (2T threshold / waterfall / analytical),
  * live-measured per-tier compressibility,
  * stats: TCO, faults, migrations, daemon tax.

The engine (window simulator, serving KV cache, or tiered optimizer) calls
``record_*`` during a window, ``fault_back`` whenever it decompresses a region
on access, and ``end_window`` at window boundaries; ``end_window`` runs the
model and returns a MigrationPlan the engine executes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core import analytical, tco
from repro_torch.core.telemetry import PEBSNoise, RegionTelemetry
from repro_torch.core.tiers import TierSet, baseline_2t_tierset, cxl_tierset, default_tierset
from repro_torch.core.waterfall import WaterfallConfig, waterfall_step


@dataclasses.dataclass(frozen=True)
class ManagerConfig:
    policy: str  # "waterfall" | "analytical" | "2t"
    hotness_threshold: float = 0.0  # H_th for waterfall/2t (absolute counts)
    alpha: float = 0.5  # knob for analytical (1=max perf, 0=max TCO savings)
    window_steps: int = 64  # engine steps per profile window
    history_windows: int = 4  # averaging depth for the analytical model
    refault_fraction: float = 0.25
    tenant: str = ""  # owning tenant in multi-tenant deploys ("" = sole tenant)
    # Quarantine hysteresis: a device reported down is re-admitted to the
    # placement frontier only after this many consecutive healthy windows.
    quarantine_healthy_windows: int = 2


# Planning latency assigned to a quarantined device's tiers: seconds where
# everything real is microseconds, so the waterfill never keeps a hot region
# there. The paired cost inflation (``plan_placement``) keeps cold regions —
# placed by min cost, ignoring latency — off the device too.
QUARANTINE_LAT_S = 1.0


@dataclasses.dataclass
class MigrationPlan:
    """end_window output: region moves the engine must execute."""

    regions: np.ndarray  # (M,) region ids to migrate
    src: np.ndarray  # (M,) old placement index
    dst: np.ndarray  # (M,) new placement index
    bytes_moved: int
    modeled_migration_s: float
    # Distinct (src, dst) pairs: a batched executor needs O(n_cohorts)
    # kernel dispatches for this plan, not O(M).
    n_cohorts: int = 0
    # Per-backing-device bandwidth charges of this plan: reads are billed to
    # each region's source device, writes to its destination device, with
    # the device's fixed per-op setup cost once per region.
    media_bytes_by_device: Dict[str, int] = dataclasses.field(default_factory=dict)
    media_s_by_device: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class WindowStats:
    window: int
    placement_hist: np.ndarray  # (N+1,) region counts per placement index
    tco_usd: float
    savings_pct: float
    faults: int
    fault_overhead_s: float  # Eq. 6 realized
    migrations: int
    migration_bytes: int
    daemon_s: float  # model eval + plan construction wall time
    modeled_migration_s: float
    migration_cohorts: int = 0  # distinct (src, dst) pairs = kernel dispatches
    # Window TCO report: migration traffic billed per backing-media device.
    media_bytes_by_device: Dict[str, int] = dataclasses.field(default_factory=dict)
    media_s_by_device: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Fault-injection / graceful-degradation counters (zero when no
    # FaultPlan is wired in): injected stage retries, payload corruptions
    # detected in the staging ring, cohorts aborted on a down device, and
    # the devices quarantined off the placement frontier this window.
    fault_retries: int = 0
    payload_corruptions: int = 0
    aborted_cohorts: int = 0
    quarantined_devices: Tuple[str, ...] = ()


class TierScapeManager:
    def __init__(
        self,
        tierset: TierSet,
        n_regions: int,
        region_bytes: int,
        cfg: ManagerConfig,
        pebs: Optional[PEBSNoise] = None,
        seed: int = 0,
    ):
        if region_bytes % tierset.block_bytes != 0:
            raise ValueError("region_bytes must be a multiple of block_bytes")
        self.tierset = tierset
        self.n_regions = n_regions
        self.region_bytes = region_bytes
        self.blocks_per_region = region_bytes // tierset.block_bytes
        self.cfg = cfg
        self.telemetry = RegionTelemetry(
            n_regions, history_len=cfg.history_windows, pebs=pebs, seed=seed
        )
        self.placement = np.zeros(n_regions, dtype=np.int64)
        # Live-measured compressibility per tier (paper feeds measured ratios
        # to the model; start at nominal).
        self.measured_ratios = np.array(tierset.ratios()[1:], dtype=np.float64)
        # Fault latency at *block* (4KB-page analogue) granularity: faults
        # decompress individual blocks on demand, each paying the fixed
        # bookkeeping + pool + media-setup costs — exactly the paper's page
        # fault path. Region-granular latency (bulk decompress, fixed costs
        # paid once) is used for pricing migrations, not faults.
        self._lat_block = np.array(tierset.latencies_s(), dtype=np.float64)
        region_elems = region_bytes // tierset.src_bytes_per_elem
        self._lat_region = np.array(
            [0.0]
            + [t.access_latency_s(region_elems, tierset.src_bytes_per_elem) for t in tierset.tiers],
            dtype=np.float64,
        )
        # Vectorized migration-pricing tables, one entry per placement index
        # (0 = uncompressed DRAM). _plan is pure numpy over these.
        sbpe = tierset.src_bytes_per_elem
        self._stored_bytes = np.array(
            [region_bytes]
            + [t.stored_bytes(region_elems, sbpe) for t in tierset.tiers],
            dtype=np.int64,
        )
        self._compress_lat = np.array(
            [0.0] + [t.compress_latency_s(region_elems, sbpe) for t in tierset.tiers],
            dtype=np.float64,
        )
        codec_names = sorted({t.codec_name for t in tierset.tiers})
        self._codec_ids = np.array(
            [-1] + [codec_names.index(t.codec_name) for t in tierset.tiers],
            dtype=np.int64,
        )
        # Backing-media devices per placement index (media subsystem): the
        # plan bills migration reads/writes to these, and live contention
        # pressure fed back via ``note_media_charges`` inflates the
        # planning latencies so placement prices bandwidth contention.
        self._devices = tierset.media_devices()
        self._dev_names = [d.name for d in self._devices]
        self._dev_read_bw = np.array([d.read_bw for d in self._devices])
        self._dev_write_bw = np.array([d.write_bw for d in self._devices])
        self._dev_fixed_s = np.array([d.fixed_latency_s for d in self._devices])
        self.media_pressure: Dict[str, float] = {}
        # Per-device wire ratio for THIS tenant's data on compressed media
        # (inline hardware compression: nominal stored bytes / bytes actually
        # moved or resident). 1.0 everywhere until ``note_media_ratio`` feeds
        # observed line compression at a window boundary. Distinct from the
        # shared AdaptiveMediaDevice EWMA, which tracks the byte-weighted
        # tenant *mix* and governs service times; this dict governs how many
        # wire bytes this tenant's plans are billed for.
        self.media_ratio: Dict[str, float] = {}
        self._window = 0
        # In-engine would-have-touched mass for host-resident regions (the
        # fused decode kernel's sentinel telemetry). Accumulates within the
        # profile window, feeds ONLY the prefetch predictor — never the
        # placement-driving access counts — and resets at window close.
        self.host_mass = np.zeros(n_regions, dtype=np.float64)
        self._fault_counts = np.zeros(n_regions, dtype=np.int64)
        self._fault_overhead_s = 0.0
        # Quarantine ledger: device name -> consecutive healthy windows seen
        # since it was last reported down. A quarantined device's tiers are
        # priced off the placement frontier; re-admission needs
        # ``cfg.quarantine_healthy_windows`` consecutive healthy reports.
        self._quarantined: Dict[str, int] = {}
        # Injected-fault counters for the current window (engine-reported).
        self._injected_retries = 0
        self._injected_corruptions = 0
        self._aborted_cohorts = 0
        self.history: List[WindowStats] = []
        self.total_daemon_s = 0.0
        self._pending_daemon_s = 0.0

    # ------------------------------------------------------------------ API
    def record_access_counts(self, counts: np.ndarray) -> None:
        self.telemetry.record(counts)

    def record_access_indices(self, idx: np.ndarray, weights=None) -> None:
        self.telemetry.record_indices(idx, weights)

    def record_host_mass(self, counts: np.ndarray) -> None:
        """Ingest would-have-touched mass for host-resident regions.

        The decode kernel's host sentinel rows score each host page's key
        centroid against live queries — the softmax mass decode *would*
        have spent on the page had it been device-resident. Telemetry for
        the warming-page predictor only (``prefetch_candidates``): it never
        enters ``telemetry``'s access counts, so placement decisions — and
        therefore prefetch's oracle-identical-placement guarantee — are
        untouched by construction."""
        self.host_mass += counts

    def fault_back(self, region_ids: np.ndarray, n_blocks=1) -> np.ndarray:
        """Engine faulted ``n_blocks`` blocks of each region on access.

        Charges Eq. 5 overhead (n_blocks * Lat_T at block granularity) and
        returns the per-region overhead. Regions whose faulted fraction
        reaches ``refault_fraction`` restart from DRAM (paper §6.3: a region
        restarts its journey when a major portion faulted back); partially
        faulted regions stay placed, their faulted blocks now living
        uncompressed (we conservatively keep charging them as compressed on
        later accesses only via fresh fault calls from the engine).
        """
        region_ids = np.atleast_1d(region_ids)
        n_blocks = np.broadcast_to(np.asarray(n_blocks, dtype=np.float64), region_ids.shape)
        src = self.placement[region_ids]
        lat = self._lat_block[src] * n_blocks
        faulted = src > 0
        self._fault_counts[region_ids[faulted]] += n_blocks[faulted].astype(np.int64)
        self._fault_overhead_s += float(lat[faulted].sum())
        move = faulted & (n_blocks >= self.cfg.refault_fraction * self.blocks_per_region)
        self.placement[region_ids[move]] = 0
        return np.where(faulted, lat, 0.0)

    def discount_fault_overhead(self, seconds: float) -> None:
        """Refund fault latency that was hidden (not avoided): a prefetched
        region's swap-in happened ahead of its first touch, so the fault's
        bookkeeping (counts, refault move) stands but its stall does not."""
        self._fault_overhead_s = max(self._fault_overhead_s - float(seconds), 0.0)

    def access_latency_s(self, region_ids: np.ndarray) -> np.ndarray:
        """Latency to access each region under the current placement."""
        src = self.placement[np.atleast_1d(region_ids)]
        return self._lat_region[src]

    @property
    def region_latencies_s(self) -> np.ndarray:
        """Per-placement-index fault latency at region granularity."""
        return self._lat_region

    def update_measured_ratio(self, tier_index: int, ratio: float, ema: float = 0.25) -> None:
        """Feed back actually-achieved compressibility for tier (1-based)."""
        i = tier_index - 1
        self.measured_ratios[i] = (1 - ema) * self.measured_ratios[i] + ema * ratio

    # ------------------------------------------------------------- prefetch
    def prefetch_candidates(
        self, eligible: np.ndarray, top_k: int, max_regions: int
    ) -> np.ndarray:
        """Warming-page predictor for speculative prefetch (readahead).

        Mid-window trend detection: a region is a candidate when its access
        rate in the *accumulating* profile window already exceeds its last
        closed window (``delta > 0`` — it is warming right now) and its
        projected hotness (``accum + delta``) ranks within the global
        top-``top_k`` — i.e. it is rising toward the promotion frontier and
        this window's placement model will plausibly pull it up-tier.
        Purely a read of telemetry: calling this never perturbs placement,
        so a speculative consumer stays bit-identical to a non-speculative
        run by construction.

        Host-resident regions additionally qualify through their in-engine
        would-have-touched mass (``record_host_mass``): live decode traffic
        scoring a host page's sentinel IS the warming signal, so it joins
        the trend term in the projection and makes a region a candidate
        even when the PEBS-analogue feed never sampled it. With no host
        mass recorded the predictor is exactly the trend detector above.

        Returns up to ``max_regions`` region ids, hottest-projected first
        (deterministic: ties broken by region id). Empty until one window
        has closed — there is no baseline to rise from before that.
        """
        if self.telemetry._windows_closed < 1 or max_regions <= 0:
            return np.empty(0, np.int64)
        h_now = self.telemetry._accum
        h_prev = self.telemetry.history[0]
        delta = h_now - h_prev
        projected = h_now + np.maximum(delta, 0.0) + self.host_mass
        mask = np.asarray(eligible, bool) & ((delta > 0) | (self.host_mass > 0))
        if not mask.any():
            return np.empty(0, np.int64)
        k = int(min(max(top_k, 1), self.n_regions))
        frontier = np.partition(projected, self.n_regions - k)[self.n_regions - k]
        cand = np.where(mask & (projected >= frontier))[0]
        if cand.size == 0:
            return cand.astype(np.int64)
        order = np.lexsort((cand, -projected[cand]))
        return cand[order][:max_regions].astype(np.int64)

    # --------------------------------------------------------------- media
    def note_media_charges(
        self, busy_s_by_device: Dict[str, float], window_s: float, ema: float = 0.5
    ) -> None:
        """Feed back executed per-device busy time for one window.

        Utilization (busy / window, clipped to 1) is EMA-folded into
        ``media_pressure``; the analytical policy prices it through
        ``contended_latencies_s`` so a saturated swap device makes its tiers
        look slower and placement routes around the contention.
        """
        for name, busy_s in busy_s_by_device.items():
            rho = min(max(busy_s, 0.0) / max(window_s, 1e-30), 1.0)
            self.media_pressure[name] = (
                (1 - ema) * self.media_pressure.get(name, 0.0) + ema * rho
            )

    def note_media_ratio(self, device: str, ratio: float, ema: float = 0.25) -> None:
        """Feed back this tenant's observed wire-compression ratio on one
        backing device (>= 1.0). Window-boundary only — callers must never
        fold observations mid-window, or replay determinism breaks."""
        r = max(float(ratio), 1.0)
        prev = self.media_ratio.get(device, r)
        self.media_ratio[device] = (1 - ema) * prev + ema * r

    def note_devices_down(self, down: Iterable[str]) -> None:
        """Feed back which backing devices are down this window (from the
        engine's fault clock). Window-boundary only, like every other
        feedback hook. A down device enters quarantine immediately; a
        quarantined device counts consecutive healthy reports and is
        re-admitted after ``cfg.quarantine_healthy_windows`` of them —
        hysteresis, so a flapping link does not thrash placements. Only the
        analytical policy prices quarantine (waterfall/2T are threshold
        ladders with no notion of per-device cost)."""
        down = set(down)
        for name in down:
            self._quarantined[name] = 0
        for name in list(self._quarantined):
            if name in down:
                continue
            self._quarantined[name] += 1
            if self._quarantined[name] >= self.cfg.quarantine_healthy_windows:
                del self._quarantined[name]

    def note_fault_events(
        self, retries: int = 0, corruptions: int = 0, aborted: int = 0
    ) -> None:
        """Accumulate the engine's injected-fault counters for this window
        (stage retries, ring corruptions detected, cohorts aborted); folded
        into the next ``WindowStats`` and reset at commit."""
        self._injected_retries += int(retries)
        self._injected_corruptions += int(corruptions)
        self._aborted_cohorts += int(aborted)

    @property
    def quarantined_devices(self) -> Tuple[str, ...]:
        return tuple(sorted(self._quarantined))

    def _quarantined_indices(self) -> List[int]:
        return sorted(
            i
            for name in self._quarantined
            for i in self.tierset.indices_for_device(name)
        )

    def contended_latencies_s(self) -> np.ndarray:
        """Per-placement-index planning latency with queueing inflation.

        M/M/1-style: a device at utilization rho serves a newcomer
        ~1/(1-rho) slower. With no recorded pressure this is exactly
        ``_lat_region`` (planning behavior unchanged until charges arrive).
        Quarantined devices' tiers get ``QUARANTINE_LAT_S`` outright — off
        the frontier entirely, not merely contended.
        """
        if not self.media_pressure and not self._quarantined:
            return self._lat_region
        lat = self._lat_region.copy()
        for i, name in enumerate(self._dev_names):
            rho = min(self.media_pressure.get(name, 0.0), 0.95)
            lat[i] *= 1.0 + rho / (1.0 - rho)
        for i in self._quarantined_indices():
            lat[i] = QUARANTINE_LAT_S
        return lat

    # -------------------------------------------------------------- window
    # The window boundary is split into three phases so a multi-tenant
    # BudgetArbiter can interpose between them: close telemetry for every
    # tenant, waterfill the global budget, then plan+commit each tenant
    # against its allotted budget. ``end_window`` composes all three for
    # single-tenant callers (unchanged behavior).
    def close_telemetry(self) -> np.ndarray:
        """Phase 1: close the profile window; returns the window's hotness."""
        t0 = time.perf_counter()
        hotness = self.telemetry.close_window()
        # Would-have-touched mass is a within-window signal: the predictor
        # reads it mid-window; the boundary starts a fresh accumulation.
        self.host_mass[:] = 0.0
        self._pending_daemon_s += time.perf_counter() - t0
        return hotness

    def plan_placement(
        self,
        hotness: np.ndarray,
        budget: Optional[float] = None,
        avg_hotness: Optional[np.ndarray] = None,
        option_costs: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Phase 2: run the placement policy; returns the proposed placement.

        ``budget`` overrides the analytical policy's self-derived alpha budget
        (USD) — this is how an arbiter-allotted per-tenant budget flows in.
        Waterfall/2T ignore it (they are threshold-, not budget-driven).
        ``avg_hotness``/``option_costs`` let an arbiter pass the values it
        already computed for the waterfill instead of recomputing them here.
        """
        t0 = time.perf_counter()
        old = self.placement
        if self.cfg.policy in ("waterfall", "2t"):
            fault_frac = (self._fault_counts > 0).astype(np.float64)
            new = waterfall_step(
                old,
                hotness,
                fault_frac,
                self.tierset.n_tiers,
                WaterfallConfig(self.cfg.hotness_threshold, self.cfg.refault_fraction),
            )
        elif self.cfg.policy == "analytical":
            avg_hot = (
                avg_hotness
                if avg_hotness is not None
                else self.telemetry.averaged_hotness(self.cfg.history_windows)
            )
            if option_costs is None:
                option_costs = tco.usd_per_region(
                    self.tierset, self.region_bytes, self.measured_ratios
                )
            if budget is None:
                budget = tco.budget(
                    self.tierset,
                    self.n_regions,
                    self.region_bytes,
                    self.cfg.alpha,
                    self.measured_ratios,
                )
            if self._quarantined:
                # Cost-mask quarantined tiers too: cold regions are placed
                # at min cost ignoring latency, so the latency mask alone
                # would still park them on a down device. A dominated
                # (huge-cost, huge-latency) option drops off the greedy's
                # convex hull entirely.
                option_costs = np.asarray(option_costs, np.float64).copy()
                option_costs[self._quarantined_indices()] = (
                    float(option_costs.max()) * 4.0 + 1.0
                )
            sol = analytical.solve_greedy(
                avg_hot, option_costs, self.contended_latencies_s(), budget
            )
            new = sol.placement
        else:
            raise ValueError(f"unknown policy {self.cfg.policy!r}")
        self._pending_daemon_s += time.perf_counter() - t0
        return new

    def commit_placement(self, new: np.ndarray) -> MigrationPlan:
        """Phase 3: adopt ``new``, price the migration, record window stats."""
        t0 = time.perf_counter()
        old = self.placement
        moved = np.where(new != old)[0]
        plan = self._plan(moved, old[moved], new[moved])
        self.placement = new
        daemon_s = time.perf_counter() - t0 + self._pending_daemon_s
        self._pending_daemon_s = 0.0
        self.total_daemon_s += daemon_s + plan.modeled_migration_s

        self.history.append(
            WindowStats(
                window=self._window,
                placement_hist=np.bincount(new, minlength=self.tierset.n_tiers + 1),
                tco_usd=tco.tco_nt(self.tierset, new, self.region_bytes, self.measured_ratios),
                savings_pct=tco.savings_pct(
                    self.tierset, new, self.region_bytes, self.measured_ratios
                ),
                faults=int(self._fault_counts.sum()),
                fault_overhead_s=self._fault_overhead_s,
                migrations=len(moved),
                migration_bytes=plan.bytes_moved,
                daemon_s=daemon_s,
                modeled_migration_s=plan.modeled_migration_s,
                migration_cohorts=plan.n_cohorts,
                media_bytes_by_device=plan.media_bytes_by_device,
                media_s_by_device=plan.media_s_by_device,
                fault_retries=self._injected_retries,
                payload_corruptions=self._injected_corruptions,
                aborted_cohorts=self._aborted_cohorts,
                quarantined_devices=self.quarantined_devices,
            )
        )
        self._window += 1
        self._fault_counts[:] = 0
        self._fault_overhead_s = 0.0
        self._injected_retries = 0
        self._injected_corruptions = 0
        self._aborted_cohorts = 0
        return plan

    def end_window(self, budget: Optional[float] = None) -> MigrationPlan:
        return self.commit_placement(self.plan_placement(self.close_telemetry(), budget))

    def _plan(self, regions: np.ndarray, src: np.ndarray, dst: np.ndarray) -> MigrationPlan:
        """Price a migration batch — vectorized numpy over (src, dst) cohorts.
        Same-codec moves skip decode/encode (paper §6.1 notes this
        optimization; we implement it). ``_plan_loop`` is the per-page
        reference semantics this must match (equivalence-tested)."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.size == 0:
            return MigrationPlan(regions, src, dst, 0, 0.0, 0)
        read_b = self._stored_bytes[src]
        write_b = self._stored_bytes[dst]
        same_codec = (self._codec_ids[src] == self._codec_ids[dst]) & (src > 0) & (dst > 0)
        # Fast path: media-to-media copy, no transcode.
        copy_s = (read_b + write_b) / 819e9
        # Transcode path: decode at src granularity + encode into dst.
        # _lat_region[0] and _compress_lat[0] are 0, matching "DRAM endpoints
        # pay no codec cost".
        code_s = self._lat_region[src] + self._compress_lat[dst]
        total_s = float(np.where(same_codec, copy_s, code_s).sum())
        total_bytes = int((read_b + write_b).sum())
        n_cohorts = int(np.unique(src * (self.tierset.n_tiers + 1) + dst).size)
        media_bytes, media_s = self._media_charges(src, dst, read_b, write_b)
        return MigrationPlan(
            regions, src, dst, total_bytes, total_s, n_cohorts,
            media_bytes_by_device=media_bytes, media_s_by_device=media_s,
        )

    def _media_charges(
        self, src: np.ndarray, dst: np.ndarray, read_b: np.ndarray, write_b: np.ndarray
    ):
        """Bill a migration batch to its backing devices: each region pays a
        read op on its source device and a write op on its destination
        device (fixed setup + bytes/bandwidth). Indexes sharing a physical
        device (e.g. both host tiers behind one PCIe link) aggregate — that
        aggregation is the shared-bandwidth contention the arbiter sees.

        Devices with an observed wire ratio (``media_ratio``, inline
        hardware compression) are billed *wire* bytes: nominal stored bytes
        divided by the tenant's committed ratio. The ratio only moves at
        window boundaries, so identical plans bill identically on replay."""
        media_bytes: Dict[str, int] = {}
        media_s: Dict[str, float] = {}
        for idx in range(len(self._devices)):
            name = self._dev_names[idx]
            r_mask = src == idx
            w_mask = dst == idx
            n_ops = int(r_mask.sum()) + int(w_mask.sum())
            if n_ops == 0:
                continue
            ratio = self.media_ratio.get(name, 1.0)
            rb = int(int(read_b[r_mask].sum()) / ratio)
            wb = int(int(write_b[w_mask].sum()) / ratio)
            t = (
                n_ops * float(self._dev_fixed_s[idx])
                + rb / float(self._dev_read_bw[idx])
                + wb / float(self._dev_write_bw[idx])
            )
            media_bytes[name] = media_bytes.get(name, 0) + rb + wb
            media_s[name] = media_s.get(name, 0.0) + t
        return media_bytes, media_s

    def _plan_loop(self, regions: np.ndarray, src: np.ndarray, dst: np.ndarray) -> MigrationPlan:
        """Per-page reference pricing (the pre-batching executor semantics).
        Kept as the oracle for the vectorized ``_plan`` and for dispatch-count
        comparisons in benchmarks; not used on the window hot path."""
        elems = self.tierset.block_elems * self.blocks_per_region
        sbpe = self.tierset.src_bytes_per_elem
        total_bytes = 0
        total_s = 0.0
        specs = [None] + list(self.tierset.tiers)
        for s, d in zip(src, dst):
            s_spec, d_spec = specs[int(s)], specs[int(d)]
            read_b = self.region_bytes if s_spec is None else s_spec.stored_bytes(elems, sbpe)
            write_b = self.region_bytes if d_spec is None else d_spec.stored_bytes(elems, sbpe)
            total_bytes += read_b + write_b
            if s_spec is not None and d_spec is not None and s_spec.codec_name == d_spec.codec_name:
                total_s += read_b / 819e9 + write_b / 819e9
            else:
                if s_spec is not None:
                    total_s += s_spec.access_latency_s(elems, sbpe)
                if d_spec is not None:
                    total_s += d_spec.compress_latency_s(elems, sbpe)
        return MigrationPlan(regions, src, dst, total_bytes, total_s)

    # -------------------------------------------------------------- views
    @property
    def current_savings_pct(self) -> float:
        return tco.savings_pct(
            self.tierset, self.placement, self.region_bytes, self.measured_ratios
        )


# ---------------------------------------------------------------------------
# Policy presets (paper §7.1 model configurations)
# ---------------------------------------------------------------------------


def make_manager(
    config_name: str,
    n_regions: int,
    region_bytes: int = 2 * 1024 * 1024,
    thresholds: dict | None = None,
    pebs: Optional[PEBSNoise] = None,
    seed: int = 0,
    window_steps: int = 64,
) -> TierScapeManager:
    """Build a manager from a paper config name.

    Names: ``2T-C|2T-M|2T-A`` (DRAM + Google-production single tier),
    ``6T-WF-C|M|A`` (waterfall on DRAM+5 tiers), ``6T-AM-0.9|0.5|0.1``
    (analytical), ``7T-CX-0.9|0.5|0.1`` (analytical over DRAM + 5 tiers +
    the hardware-compressed CXL expander). Thresholds dict maps C/M/A ->
    absolute H_th (workload specific, like the paper's Memcached 50/100/250).
    """
    thresholds = thresholds or {"C": 50.0, "M": 100.0, "A": 250.0}
    name = config_name.upper()
    if name.startswith("2T-"):
        level = name.split("-")[1]
        ts = baseline_2t_tierset()
        cfg = ManagerConfig(
            policy="2t", hotness_threshold=thresholds[level], window_steps=window_steps
        )
    elif name.startswith("6T-WF-"):
        level = name.split("-")[2]
        ts = default_tierset()
        cfg = ManagerConfig(
            policy="waterfall", hotness_threshold=thresholds[level], window_steps=window_steps
        )
    elif name.startswith("6T-AM-"):
        alpha = float(name.split("AM-")[1])
        ts = default_tierset()
        cfg = ManagerConfig(policy="analytical", alpha=alpha, window_steps=window_steps)
    elif name.startswith("7T-CX-"):
        alpha = float(name.split("CX-")[1])
        ts = cxl_tierset()
        cfg = ManagerConfig(policy="analytical", alpha=alpha, window_steps=window_steps)
    else:
        raise ValueError(f"unknown config {config_name!r}")
    return TierScapeManager(ts, n_regions, region_bytes, cfg, pebs=pebs, seed=seed)
