"""Global budget arbiter for multi-tenant tiersets (paper §8 direction).

One ``TierScapeManager`` per tenant — each with its own telemetry, placement
policy and SLA/TCO targets — shares the physical pools. Every profile window
the ``BudgetArbiter``:

  1. closes every tenant's telemetry window,
  2. **waterfills** the fleet-wide TCO budget (Eq. 2's bound, summed over
     tenants) across tenants by marginal TCO-saving per unit of perf impact:
     the globally cheapest demotion edges — smallest
     ``sla_weight * hotness * Δlat / Δcost_saved`` — are taken first until the
     fleet fits the budget, so the hotter / higher-SLA tenant keeps its fast
     tier and the cheapest marginal pages (usually the colder tenant's) are
     demoted,
  3. lets each tenant's manager plan autonomously against its allotted
     budget (analytical tenants consume the budget; waterfall/2T tenants
     plan by threshold and are bounded by step 4),
  4. reconciles shared-pool over-subscription: when a tier's region capacity
     is exceeded across tenants, the cheapest marginal pages (smallest
     weighted hotness) are demoted to the next tier with headroom,
  5. commits every tenant's placement and records per-tenant + fleet stats.

SLA floors: a tenant is never demoted below
``tco_min + alpha_floor * (tco_max - tco_min)`` USD of residency — a starved
tenant keeps at least that much fast-tier budget even when another tenant's
pages are globally hotter. The capacity pass honors floors too (victims are
taken from above-floor tenants first); only when physical capacity cannot
hold every tenant's floor does it breach one — capacity is physical, USD
floors are policy.

Determinism: the waterfill is a single stable argsort over concatenated edge
keys plus an in-order take; with fixed seeds (telemetry, workloads) the
allotted budgets and placements are bit-identical across runs.

A copy of ``repro.core.arbiter`` (numpy on the host, the same float order),
so its budgets, placements and fleet reports equal the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import tco
from repro_torch.core.analytical import _hull_indices
from repro_torch.core.manager import MigrationPlan, TierScapeManager
from repro_torch.core.pools import TenantLedger


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """SLA/TCO contract of one tenant sharing the tierset substrate."""

    name: str
    # Relative price of this tenant's perf impact in the waterfill: a page of
    # weight-2 tenant is demoted only after an equally-hot page of a weight-1
    # tenant. >1 = latency-sensitive, <1 = batch/best-effort.
    sla_weight: float = 1.0
    # Guaranteed budget floor as a fraction of the tenant's [TCO_min, TCO_max]
    # span. The arbiter never *demotes* the tenant below this spend; a tenant
    # with zero measured hotness still parks at min cost voluntarily (there
    # is no perf to protect, so reserving budget for it would be waste).
    alpha_floor: float = 0.0

    def __post_init__(self):
        if self.sla_weight <= 0:
            raise ValueError("sla_weight must be positive")
        if not 0.0 <= self.alpha_floor <= 1.0:
            raise ValueError("alpha_floor must be in [0, 1]")


@dataclasses.dataclass
class TenantWindowStats:
    tenant: str
    window: int
    budget_usd: float  # allotted by the waterfill (incl. slack share)
    spent_usd: float  # committed placement cost
    sla_floor_usd: float
    savings_pct: float
    fast_regions: int  # regions resident in placement 0 (uncompressed)
    weighted_penalty_s: float  # sla_weight * sum(hot * Lat) of the commit
    # Decode demand the tenant presented this window (closed-window access
    # total, PEBS-noised if telemetry is) — the capacity planner's
    # throughput-demand signal.
    demand_accesses: float = 0.0


@dataclasses.dataclass
class ArbiterWindowStats:
    window: int
    global_budget_usd: float
    fleet_tco_usd: float
    fleet_savings_pct: float
    budget_feasible: bool  # False when SLA floors force spend above budget
    tenants: List[TenantWindowStats]
    # Shared-bandwidth reconcile: fleet migration bytes billed per device
    # and moves deferred because a device's window budget was exhausted.
    media_bytes_by_device: Dict[str, float] = dataclasses.field(default_factory=dict)
    deferred_migrations: int = 0
    # Speculative prefetch traffic recorded mid-window: already moved, so it
    # consumed the device budgets before any demand move was considered.
    speculative_bytes_by_device: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    # Fleet fault/degradation aggregates (sums over tenants' WindowStats;
    # zero when no FaultPlan is wired in): injected stage retries, ring
    # corruptions detected, cohorts aborted on down devices, and the union
    # of devices any tenant held quarantined this window.
    fault_retries: int = 0
    payload_corruptions: int = 0
    aborted_cohorts: int = 0
    quarantined_devices: Tuple[str, ...] = ()


class BudgetArbiter:
    """Splits per-tier capacity + the global TCO budget across N tenants."""

    def __init__(
        self,
        specs: Sequence[TenantSpec],
        managers: Sequence[TierScapeManager],
        alpha: float = 0.5,
        tier_capacity_regions: Optional[np.ndarray] = None,
        media_bw_budget_bytes: Optional[Dict[str, float]] = None,
    ):
        """``media_bw_budget_bytes`` caps, per backing-media device, the
        migration bytes the whole fleet may move in one window (bandwidth is
        a shared resource exactly like tier capacity). Moves exceeding a
        device's budget are deferred — the placement keeps its old value and
        the policy retries next window — coldest weighted pages first."""
        if len(specs) != len(managers):
            raise ValueError("one manager per tenant spec")
        if len({s.name for s in specs}) != len(specs):
            raise ValueError("tenant names must be unique")
        n_opts = {m.tierset.n_tiers + 1 for m in managers}
        if len(n_opts) != 1:
            raise ValueError("all tenants must share the tierset structure")
        self.n_options = n_opts.pop()
        self.specs = list(specs)
        self.managers = list(managers)
        self.alpha = alpha
        if tier_capacity_regions is None:
            cap = np.full(self.n_options, np.inf)
        else:
            cap = np.asarray(tier_capacity_regions, dtype=np.float64)
            if cap.shape != (self.n_options,):
                raise ValueError(f"capacity must have shape ({self.n_options},)")
            if cap.sum() < sum(m.n_regions for m in managers):
                raise ValueError("pool capacities cannot hold the fleet's regions")
        self.capacity_regions = cap
        self.media_bw_budget_bytes = dict(media_bw_budget_bytes or {})
        self.ledger = TenantLedger([s.name for s in specs], cap)
        self.history: List[ArbiterWindowStats] = []
        self._window = 0
        self._spec_bytes: Dict[str, float] = {}
        # Scheduler-measured decode demand (tokens decoded per tenant per
        # frontend scheduling window). When any records exist they REPLACE
        # the telemetry access sums as ``fleet_report``'s demand signal.
        self._sched_demand: List[Dict[str, float]] = []

    def record_scheduled_demand(self, demand: Dict[str, float]) -> None:
        """Record one frontend scheduling window's measured decode demand
        (tenant name -> tokens decoded). The capacity planner then prices
        fleets against what the scheduler actually served, not a synthetic
        per-window constant."""
        known = {s.name for s in self.specs}
        unknown = set(demand) - known
        if unknown:
            raise KeyError(f"unknown tenant(s) in scheduled demand: {sorted(unknown)}")
        self._sched_demand.append({k: float(v) for k, v in demand.items()})

    def record_speculative_bytes(self, bytes_by_device: Dict[str, float]) -> None:
        """Bill mid-window speculative prefetch traffic against the shared
        per-device bandwidth budgets. The bytes were already moved by the
        time the window closes, so the upcoming reconcile has that much
        less headroom for demand migrations on the same device —
        mispredicted speculation consumes real budget and shows up as
        deferred demand moves rather than disappearing."""
        for dev, b in bytes_by_device.items():
            self._spec_bytes[dev] = self._spec_bytes.get(dev, 0.0) + float(b)

    # ----------------------------------------------------------------- window
    def global_budget_usd(self) -> float:
        """Fleet-wide Eq. 2 bound: sum of per-tenant alpha-budgets."""
        return sum(
            tco.budget(m.tierset, m.n_regions, m.region_bytes, self.alpha, m.measured_ratios)
            for m in self.managers
        )

    def sla_floor_usd(self, t: int) -> float:
        m, s = self.managers[t], self.specs[t]
        mx = tco.tco_max(m.n_regions, m.region_bytes)
        mn = tco.tco_min(m.tierset, m.n_regions, m.region_bytes, m.measured_ratios)
        return mn + s.alpha_floor * (mx - mn)

    def end_window(self) -> Dict[str, MigrationPlan]:
        """Arbitrate one window; returns each tenant's migration plan."""
        hots = [m.close_telemetry() for m in self.managers]
        avg_hots = [
            m.telemetry.averaged_hotness(m.cfg.history_windows) for m in self.managers
        ]
        costs = [
            tco.usd_per_region(m.tierset, m.region_bytes, m.measured_ratios)
            for m in self.managers
        ]
        # Contended latencies: devices saturated in previous windows make
        # their tiers look slower to every tenant's waterfill.
        lats = [m.contended_latencies_s() for m in self.managers]
        floors = [self.sla_floor_usd(t) for t in range(len(self.specs))]
        global_budget = self.global_budget_usd()

        budgets = self._waterfill(avg_hots, costs, lats, floors, global_budget)

        news = []
        for t, m in enumerate(self.managers):
            if m.cfg.policy == "analytical":
                news.append(
                    m.plan_placement(
                        hots[t], budget=budgets[t],
                        avg_hotness=avg_hots[t], option_costs=costs[t],
                    )
                )
            else:
                news.append(m.plan_placement(hots[t]))
        news, deferred = self._reconcile_bandwidth(news, avg_hots)
        news = self._reconcile_capacity(news, avg_hots, costs, floors)

        plans: Dict[str, MigrationPlan] = {}
        tenant_stats: List[TenantWindowStats] = []
        media_bytes: Dict[str, float] = {}
        for t, (m, s) in enumerate(zip(self.managers, self.specs)):
            plans[s.name] = m.commit_placement(news[t])
            # Fleet media traffic as COMMITTED (capacity-pass moves included,
            # deferred moves excluded) — agrees with the tenants' WindowStats.
            for dev, b in plans[s.name].media_bytes_by_device.items():
                media_bytes[dev] = media_bytes.get(dev, 0.0) + b
            self.ledger.set_usage(
                s.name, np.bincount(news[t], minlength=self.n_options)
            )
            spent = tco.tco_nt(m.tierset, news[t], m.region_bytes, m.measured_ratios)
            tenant_stats.append(
                TenantWindowStats(
                    tenant=s.name,
                    window=self._window,
                    budget_usd=budgets[t],
                    spent_usd=spent,
                    sla_floor_usd=floors[t],
                    savings_pct=m.history[-1].savings_pct,
                    fast_regions=int((news[t] == 0).sum()),
                    weighted_penalty_s=float(
                        s.sla_weight * (avg_hots[t] * lats[t][news[t]]).sum()
                    ),
                    demand_accesses=float(np.asarray(hots[t]).sum()),
                )
            )
        # Fleet fault aggregates: each manager's just-committed WindowStats
        # carries its engine-reported fault counters for this window.
        last = [m.history[-1] for m in self.managers]
        quarantined = sorted({d for ws in last for d in ws.quarantined_devices})
        # After commit every manager's placement == news[t], so the fleet
        # aggregation helpers price exactly what was just committed.
        self.history.append(
            ArbiterWindowStats(
                window=self._window,
                global_budget_usd=global_budget,
                fleet_tco_usd=tco.fleet_tco_usd(self.managers),
                fleet_savings_pct=tco.fleet_savings_pct(self.managers),
                budget_feasible=sum(budgets) <= global_budget * (1 + 1e-9),
                tenants=tenant_stats,
                media_bytes_by_device=media_bytes,
                deferred_migrations=deferred,
                speculative_bytes_by_device=dict(self._spec_bytes),
                fault_retries=sum(ws.fault_retries for ws in last),
                payload_corruptions=sum(ws.payload_corruptions for ws in last),
                aborted_cohorts=sum(ws.aborted_cohorts for ws in last),
                quarantined_devices=tuple(quarantined),
            )
        )
        self._spec_bytes = {}
        self._window += 1
        return plans

    # -------------------------------------------------------------- waterfill
    def _waterfill(
        self,
        avg_hots: Sequence[np.ndarray],
        costs: Sequence[np.ndarray],
        lats: Sequence[np.ndarray],
        floors: Sequence[float],
        global_budget: float,
    ) -> List[float]:
        """Split ``global_budget`` across tenants by marginal utility.

        Mirrors ``analytical.solve_greedy``'s LP-greedy, but the edge pool is
        fleet-wide and each edge key is scaled by the tenant's SLA weight.
        Returns per-tenant USD budgets that sum exactly to
        ``max(global_budget, sum of floor-clamped spends)``.
        """
        n_t = len(self.specs)
        spend = np.zeros(n_t)
        edge_key: List[np.ndarray] = []
        edge_tenant: List[np.ndarray] = []
        edge_saving: List[np.ndarray] = []
        edge_region: List[np.ndarray] = []

        for t in range(n_t):
            hot = np.asarray(avg_hots[t], dtype=np.float64)
            hull = _hull_indices(costs[t], lats[t])
            hull_costs = costs[t][hull]
            cold = hot <= 0
            # Start everyone at min-penalty; cold regions at min cost (their
            # penalty is 0 everywhere — exactly solve_greedy's opening state).
            spend[t] = float(
                (~cold).sum() * hull_costs[0] + cold.sum() * costs[t].min()
            )
            if len(hull) < 2:
                continue
            d_cost = hull_costs[:-1] - hull_costs[1:]  # (E,) > 0 saved per edge
            d_lat = lats[t][hull][1:] - lats[t][hull][:-1]  # (E,) >= 0 added
            slopes = np.where(d_cost > 0, d_lat / np.maximum(d_cost, 1e-30), np.inf)
            hot_idx = np.where(~cold)[0]
            if hot_idx.size == 0:
                continue
            keys = self.specs[t].sla_weight * hot[hot_idx][:, None] * slopes[None, :]
            edge_key.append(keys.reshape(-1))
            edge_tenant.append(np.full(keys.size, t, dtype=np.int64))
            edge_saving.append(
                np.broadcast_to(d_cost[None, :], keys.shape).reshape(-1)
            )
            edge_region.append(
                np.broadcast_to(
                    np.arange(hot_idx.size)[:, None], keys.shape
                ).reshape(-1)
            )

        need = float(spend.sum()) - global_budget
        if need > 0 and edge_key:
            keys = np.concatenate(edge_key)
            tenants = np.concatenate(edge_tenant)
            savings = np.concatenate(edge_saving)
            regions = np.concatenate(edge_region)
            order = np.argsort(keys, kind="stable")
            blocked: set = set()
            for i in order:
                t = int(tenants[i])
                key = (t, int(regions[i]))
                if key in blocked:
                    continue
                dc = float(savings[i])
                if spend[t] - dc < floors[t] - 1e-12:
                    # This demotion would breach the tenant's SLA floor. A
                    # region's hull edges must be taken in order, so block
                    # this region's remaining chain — but keep considering
                    # the tenant's other regions, whose next edges may save
                    # less and still fit above the floor.
                    blocked.add(key)
                    continue
                spend[t] -= dc
                need -= dc
                if need <= 0:
                    break

        budgets = spend.copy()
        slack = global_budget - float(spend.sum())
        if slack > 0:
            # Distribute unneeded headroom by SLA weight so budgets sum to
            # the global budget exactly (the ledger invariant).
            w = np.array([s.sla_weight for s in self.specs])
            budgets = budgets + slack * w / w.sum()
        return [float(b) for b in budgets]

    # --------------------------------------------------- bandwidth reconcile
    def _reconcile_bandwidth(
        self, news: List[np.ndarray], avg_hots: Sequence[np.ndarray]
    ):
        """Enforce per-device migration-bandwidth budgets fleet-wide.

        Every planned move bills a read to its source device and a write to
        its destination device (the manager's media cost model). When a
        device's billed bytes exceed its per-window budget, the cheapest
        marginal moves touching that device — smallest ``sla_weight *
        hotness`` fleet-wide, ties by region index — are *deferred*: the
        region keeps its current placement and the policy re-plans it next
        window. Bandwidth behaves exactly like tier capacity: a shared
        physical resource the arbiter rations, which is what keeps one
        tenant's migration storm from stealing the PCIe link out from under
        another tenant's swap-ins (the MaxMem contention failure).

        Runs before the capacity reconcile (deferring a move can leave a
        tier overfull, which capacity then resolves); capacity-pass moves
        are therefore not bandwidth-capped — a documented one-pass
        approximation. The committed per-device traffic reported in
        ``ArbiterWindowStats`` is aggregated from the tenants' committed
        plans, so it includes those moves.

        Returns (news, total deferred moves).
        """
        if not self.media_bw_budget_bytes:
            return news, 0

        # Flatten every tenant's moves with their per-device byte bills.
        move_t: List[np.ndarray] = []
        move_r: List[np.ndarray] = []
        move_key: List[np.ndarray] = []
        move_read_dev: List[np.ndarray] = []
        move_write_dev: List[np.ndarray] = []
        move_read_b: List[np.ndarray] = []
        move_write_b: List[np.ndarray] = []
        for t, m in enumerate(self.managers):
            moved = np.where(news[t] != m.placement)[0]
            if moved.size == 0:
                continue
            src = m.placement[moved]
            dst = news[t][moved]
            move_t.append(np.full(moved.size, t, np.int64))
            move_r.append(moved)
            hot = np.asarray(avg_hots[t], dtype=np.float64)[moved]
            move_key.append(self.specs[t].sla_weight * hot)
            names = np.array(m._dev_names)
            move_read_dev.append(names[src])
            move_write_dev.append(names[dst])
            # Bill *wire* bytes: devices with an inline hardware compressor
            # move nominal/ratio bytes for this tenant's data (the same
            # accounting the manager's _media_charges applies; the ratio
            # moves only at window boundaries, so replay bills identically).
            r_ratio = np.array([m.media_ratio.get(n, 1.0) for n in names[src]])
            w_ratio = np.array([m.media_ratio.get(n, 1.0) for n in names[dst]])
            move_read_b.append(m._stored_bytes[src].astype(np.float64) / r_ratio)
            move_write_b.append(m._stored_bytes[dst].astype(np.float64) / w_ratio)
        if not move_t:
            return news, 0

        tenants = np.concatenate(move_t)
        regions = np.concatenate(move_r)
        keys = np.concatenate(move_key)
        rdev = np.concatenate(move_read_dev)
        wdev = np.concatenate(move_write_dev)
        rb = np.concatenate(move_read_b)
        wb = np.concatenate(move_write_b)

        spend: Dict[str, float] = {}
        for i in range(tenants.size):
            spend[rdev[i]] = spend.get(rdev[i], 0.0) + rb[i]
            spend[wdev[i]] = spend.get(wdev[i], 0.0) + wb[i]
        alive = np.ones(tenants.size, bool)
        order = np.lexsort((regions, tenants, keys))  # coldest weighted first
        for dev, budget in self.media_bw_budget_bytes.items():
            # Speculative prefetch already spent part of this device's
            # window budget; only the remainder is available to demand moves.
            budget = max(budget - self._spec_bytes.get(dev, 0.0), 0.0)
            if spend.get(dev, 0.0) <= budget:
                continue
            for i in order:
                if not alive[i]:
                    continue
                if rdev[i] != dev and wdev[i] != dev:
                    continue
                # Defer: undo both of the move's device bills.
                spend[rdev[i]] -= rb[i]
                spend[wdev[i]] -= wb[i]
                alive[i] = False
                news[int(tenants[i])][int(regions[i])] = self.managers[
                    int(tenants[i])
                ].placement[int(regions[i])]
                if spend.get(dev, 0.0) <= budget:
                    break
        return news, int((~alive).sum())

    # ---------------------------------------------------- capacity reconcile
    def _reconcile_capacity(
        self,
        news: List[np.ndarray],
        avg_hots: Sequence[np.ndarray],
        costs: Sequence[np.ndarray],
        floors: Sequence[float],
    ) -> List[np.ndarray]:
        """Enforce shared per-tier region capacities across tenants.

        Overfull tiers shed their cheapest marginal pages — smallest
        ``sla_weight * hotness`` fleet-wide — to the next tier index with
        headroom (denser/cheaper, the demotion direction). Victims whose
        tenant would drop below its SLA floor are skipped while any
        above-floor victim exists; if capacity physically cannot hold every
        floor, the coldest page goes regardless (capacity wins over policy).
        When no deeper tier has headroom the overflow spills *upward* into
        the shallowest-constrained faster tier instead (hottest pages first —
        promotion raises spend, so floors are never at risk); the constructor
        guarantees total capacity holds the fleet, so one direction always
        has room.
        """
        if not np.isfinite(self.capacity_regions).any():
            return news
        sizes = [n.size for n in news]
        pl = np.concatenate(news)
        hot = np.concatenate([np.asarray(h, dtype=np.float64) for h in avg_hots])
        tenant_of = np.concatenate(
            [np.full(sz, t, dtype=np.int64) for t, sz in enumerate(sizes)]
        )
        w = np.array([s.sla_weight for s in self.specs])[tenant_of]
        spend = np.array(
            [float(costs[t][news[t]].sum()) for t in range(len(sizes))]
        )
        counts = np.bincount(pl, minlength=self.n_options).astype(np.float64)
        n_t = len(sizes)
        for k in range(self.n_options):
            over = counts[k] - self.capacity_regions[k]
            if over <= 0:
                continue
            over = int(np.ceil(over))
            idx = np.where(pl == k)[0]
            order = np.lexsort((idx, w[idx] * hot[idx]))  # coldest weighted first
            cand = idx[order]
            while over > 0:
                dst = next(
                    (j for j in range(k + 1, self.n_options)
                     if counts[j] + 1 <= self.capacity_regions[j]),
                    None,
                )
                if dst is None:
                    # No deeper headroom: spill upward to the nearest faster
                    # tier with room (total capacity was validated, so it
                    # exists unless every tier is simultaneously full).
                    dst = next(
                        (j for j in range(k - 1, -1, -1)
                         if counts[j] + 1 <= self.capacity_regions[j]),
                        None,
                    )
                if dst is None or cand.size == 0:
                    raise MemoryError(
                        f"tier capacities cannot absorb overflow from tier {k}"
                    )
                room = int(min(self.capacity_regions[dst] - counts[dst], over))
                delta = np.array(
                    [costs[t][dst] - costs[t][k] for t in range(n_t)]
                )
                if dst > k:
                    # Demotion (one batch per destination tier): each tenant
                    # can shed at most floor((spend - floor) / cost_drop)
                    # pages before breaching its SLA floor; fill the room
                    # coldest-first under those per-tenant quotas.
                    quota = np.where(
                        delta < 0,
                        np.floor((spend - np.asarray(floors) + 1e-12)
                                 / np.maximum(-delta, 1e-30)),
                        np.inf,
                    )
                    take, keep = [], []
                    for r in cand:
                        t = tenant_of[r]
                        if len(take) < room and quota[t] >= 1:
                            quota[t] -= 1
                            take.append(r)
                        else:
                            keep.append(r)
                    if not take:
                        # Every candidate's floor would break: capacity is
                        # physical, so the coldest pages go regardless.
                        take, keep = list(cand[:room]), list(cand[room:])
                    take = np.array(take, dtype=np.int64)
                    cand = np.array(keep, dtype=np.int64)
                else:
                    # Promotion: hottest pages benefit, and spend only
                    # rises, so SLA floors cannot be violated.
                    take = cand[-room:]
                    cand = cand[:-room]
                pl[take] = dst
                np.add.at(spend, tenant_of[take], delta[tenant_of[take]])
                counts[dst] += take.size
                counts[k] -= take.size
                over -= take.size
        out, off = [], 0
        for sz in sizes:
            out.append(pl[off : off + sz])
            off += sz
        return out

    # ------------------------------------------------------------------ views
    def tenant_history(self, name: str) -> List[TenantWindowStats]:
        return [
            ts for ws in self.history for ts in ws.tenants if ts.tenant == name
        ]

    def fleet_report(self, last_windows: Optional[int] = None):
        """Summarize the arbiter's recent history as the ``FleetReport`` the
        capacity planner consumes — the live-telemetry bridge from
        ``ArbiterWindowStats`` + per-tenant ``WindowStats`` to
        "how many servers, which tier mix, at what dollar cost".

        ``last_windows`` restricts the aggregation to the most recent N
        windows (e.g. to drop a simulation's warmup); default is the whole
        history. Per-tenant resident bytes are grouped by each tier's
        backing media device from the managers' committed placement
        histograms, so the planner's bin-packing sees the same bytes the
        byte-level TCO model (Eq. 12) priced.
        """
        from repro_torch.core.capacity import FleetReport

        if not self.history:
            raise ValueError("fleet_report needs at least one closed window")
        hist = self.history[-last_windows:] if last_windows else self.history
        n_w = len(hist)

        bytes_by_dev: List[Dict[str, float]] = []
        for m in self.managers:
            mgr_hist = m.history[-n_w:]
            acc: Dict[str, float] = {}
            for ws in mgr_hist:
                resident = ws.placement_hist * m._stored_bytes
                for i, dev in enumerate(m._dev_names):
                    # Physical occupancy: inline-compressed devices hold
                    # nominal/ratio bytes of this tenant's data, so the
                    # planner's bin-packing sees effective capacity.
                    ratio = m.media_ratio.get(dev, 1.0)
                    acc[dev] = acc.get(dev, 0.0) + float(resident[i]) / ratio
            bytes_by_dev.append({d: b / max(len(mgr_hist), 1) for d, b in acc.items()})

        media: Dict[str, float] = {}
        for ws in hist:
            for dev, b in ws.media_bytes_by_device.items():
                media[dev] = media.get(dev, 0.0) + float(b)
            for dev, b in ws.speculative_bytes_by_device.items():
                media[dev] = media.get(dev, 0.0) + float(b)
        media = {d: b / n_w for d, b in media.items()}

        n_t = len(self.specs)
        if self._sched_demand:
            # Scheduler-measured decode demand wins over the telemetry sum:
            # mean tokens/window per tenant across the recorded frontend
            # windows (same ``last_windows`` trim as the history).
            sched = (
                self._sched_demand[-last_windows:]
                if last_windows else self._sched_demand
            )
            demand = tuple(
                float(np.mean([w.get(s.name, 0.0) for w in sched]))
                for s in self.specs
            )
        else:
            demand = tuple(
                float(np.mean([ws.tenants[t].demand_accesses for ws in hist]))
                for t in range(n_t)
            )
        penalty = tuple(
            float(np.mean([ws.tenants[t].weighted_penalty_s for ws in hist]))
            for t in range(n_t)
        )
        return FleetReport(
            windows=n_w,
            tenant_names=tuple(s.name for s in self.specs),
            tenant_footprint_bytes=tuple(
                float(m.n_regions) * float(m.region_bytes) for m in self.managers
            ),
            tenant_bytes_by_device=tuple(bytes_by_dev),
            tenant_demand_accesses=demand,
            tenant_penalty_s=penalty,
            per_window_penalty_s=np.array(
                [sum(ts.weighted_penalty_s for ts in ws.tenants) for ws in hist]
            ),
            fleet_tco_usd=float(np.mean([ws.fleet_tco_usd for ws in hist])),
            fleet_savings_pct=float(np.mean([ws.fleet_savings_pct for ws in hist])),
            media_bytes_by_device=media,
            budget_feasible_frac=float(np.mean([ws.budget_feasible for ws in hist])),
            fault_retries=int(sum(ws.fault_retries for ws in hist)),
            payload_corruptions=int(sum(ws.payload_corruptions for ws in hist)),
            aborted_cohorts=int(sum(ws.aborted_cohorts for ws in hist)),
            quarantine_windows=int(
                sum(1 for ws in hist if ws.quarantined_devices)
            ),
        )
