"""Fleet-level TCO capacity planner — the paper's headline metric, priced.

The paper's claim is dollars, not microseconds: multiple software-defined
compressed tiers buy 22-40 points of memory-TCO savings at performance
parity (§1, Eq. 9-12). ``core/tco.py`` prices bytes-in-tiers; this module
closes the loop to "how many servers, which tier mix, at what amortized
dollar cost" for a whole fleet:

  * ``ServerSpec`` — a server-level cost model in the spirit of the classic
    private-cloud cost models: purchase + deployment + annual maintenance +
    rack space + power, amortized over a configurable operating period, plus
    the capacity vector a server contributes (HBM / host DRAM / CXL / NVMe
    bytes, decode throughput, per-device migration bandwidth).
  * ``FleetReport`` — the live multi-tenant telemetry summary the planner
    consumes, produced by ``BudgetArbiter.fleet_report()`` from
    ``ArbiterWindowStats`` + per-tenant ``WindowStats``: per-tenant resident
    bytes by backing device, decode demand, latency-penalty distribution,
    fleet TCO, migration traffic per device.
  * ``CapacityPlanner`` — bin-packs tenant footprints + decode-throughput
    demand onto servers (first-fit decreasing over the multi-dimensional
    capacity vector, deterministic), prices the packed fleet against an
    all-DRAM-provisioned reference fleet of the same server spec, and
    searches tier configurations (codec split via ``warm_bits``/
    ``cold_bits``, fast-tier capacity fraction, arbiter ``alpha``, 2T vs 6T
    family) to emit a Pareto frontier of perf-per-dollar points.

Every step is pure numpy + integer arithmetic over a seeded simulation, so
a sweep is bit-reproducible: the same grid on the same seed emits the same
frontier JSON byte-for-byte, equal to ``repro.core.capacity``'s, of which
this module is a copy.

The ``SERVERS`` catalog (``v5e-*``) and the $/GB terms of ``core/hw.py`` are
the reference's model inputs, kept unchanged: they price a modeled fleet and
are not measurements of the GPU the port runs on. The catalog has no GPU
server. Savings and server counts from the planner are model outputs on
that catalog.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.manager import ManagerConfig, TierScapeManager, make_manager

GIB = 1024**3

# Demand/capacity dimension keys: "mem:<device>" is resident bytes on a
# backing device, "bw:<device>" is migration bytes per window through it,
# "decode" is access throughput (accesses per window).
MEM = "mem:"
BW = "bw:"
DECODE = "decode"


def _r(x: float) -> float:
    """Round to 12 significant digits for stable, readable JSON."""
    return float(f"{float(x):.12g}")


# ---------------------------------------------------------------------------
# Server cost + capacity model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """One purchasable server configuration and its amortized cost.

    Costs are in the same relative USD units as ``hw.CostSpec`` (only
    ratios matter). The amortization follows the private-cloud cost model
    shape: purchase is paid once, maintenance is a yearly percentage of
    purchase, rack and power accrue per operating year.
    """

    name: str
    # Memory capacity contributed per server, by backing-media device.
    hbm_gb: float
    host_dram_gb: float
    cxl_gb: float = 0.0
    # Hardware-compressed CXL expander (inline line compressor): capacity is
    # RAW media GB — the planner packs *physical* occupancy (fleet_report
    # already divides resident bytes by the observed line ratio), so the
    # compressor's effective-capacity multiplier shows up on the demand
    # side, not as a fudge here.
    cxl_hw_gb: float = 0.0
    nvme_gb: float = 0.0
    # Decode throughput one server sustains (accesses per profile window —
    # the simulator's demand unit).
    decode_accesses_per_window: float = 8e6
    # Migration-bandwidth budgets per profile window (bytes) through each
    # backing device one server carries; the shared resources the arbiter
    # rations fleet-wide. The HBM budget is the migration share only —
    # decode traffic owns the rest of the link.
    pcie_window_bytes: float = 25e9
    hbm_window_bytes: float = 100e9
    cxl_window_bytes: float = 48e9
    cxl_hw_window_bytes: float = 48e9
    nvme_window_bytes: float = 5e9
    # Dollars (relative units, hw.CostSpec scale).
    base_usd: float = 1900.0  # chassis + CPU + accelerator, memory excluded
    deployment_usd: float = 100.0
    annual_maintenance_pct: float = 10.0
    rack_usd_per_year: float = 120.0
    power_kw: float = 0.6
    usd_per_kwh: float = 0.02

    def purchase_usd(self) -> float:
        """Server purchase price: base + memory at the tco.py $/GB scale."""
        from repro_torch.core import hw

        return (
            self.base_usd
            + self.hbm_gb * hw.COSTS.usd_per_gb_hbm
            + self.host_dram_gb * hw.COSTS.usd_per_gb_host
            # CXL-attached and NVMe capacity at published relative $/GB
            # points below host DRAM (the ZeroPoint CXL pricing direction).
            + self.cxl_gb * hw.COSTS.usd_per_gb_host * 0.75
            # Hardware-compressed expander media is cheaper per raw GB
            # (hw.CostSpec's cxl point); the controller silicon rides in
            # base_usd of the server configs that carry it.
            + self.cxl_hw_gb * hw.COSTS.usd_per_gb_cxl
            + self.nvme_gb * 0.08
        )

    def amortized_usd(self, operating_period_years: float) -> float:
        """Total cost of owning one server for the operating period."""
        if operating_period_years <= 0:
            raise ValueError("operating_period_years must be positive")
        purchase = self.purchase_usd()
        maintenance = (
            self.annual_maintenance_pct / 100.0 * purchase * operating_period_years
        )
        rack = self.rack_usd_per_year * operating_period_years
        power = (
            self.power_kw * 24.0 * 365.0 * operating_period_years * self.usd_per_kwh
        )
        return purchase + self.deployment_usd + maintenance + rack + power

    def capacity_vector(self) -> Dict[str, float]:
        """Per-dimension capacity one server contributes to the fleet."""
        cap = {
            MEM + "hbm": self.hbm_gb * GIB,
            MEM + "host_dram_pcie": self.host_dram_gb * GIB,
            DECODE: self.decode_accesses_per_window,
            BW + "hbm": self.hbm_window_bytes,
            BW + "host_dram_pcie": self.pcie_window_bytes,
        }
        if self.cxl_gb > 0:
            cap[MEM + "cxl"] = self.cxl_gb * GIB
            cap[BW + "cxl"] = self.cxl_window_bytes
        if self.cxl_hw_gb > 0:
            cap[MEM + "cxl_hw"] = self.cxl_hw_gb * GIB
            cap[BW + "cxl_hw"] = self.cxl_hw_window_bytes
        if self.nvme_gb > 0:
            cap[MEM + "nvme"] = self.nvme_gb * GIB
            cap[BW + "nvme"] = self.nvme_window_bytes
        return cap


# Catalog: the v5e-host pairing the rest of the repo models, plus the
# denser-host and CXL-expanded variants the composable-memory direction
# targets. hbm/host sizes mirror hw.ChipSpec.
SERVERS: Dict[str, ServerSpec] = {
    s.name: s
    for s in (
        ServerSpec("v5e-base", hbm_gb=16.0, host_dram_gb=512.0),
        ServerSpec("v5e-bighost", hbm_gb=16.0, host_dram_gb=1536.0,
                   base_usd=2100.0, power_kw=0.7),
        ServerSpec("v5e-cxl", hbm_gb=16.0, host_dram_gb=512.0, cxl_gb=1024.0,
                   base_usd=2200.0, power_kw=0.75),
        ServerSpec("v5e-cxlhw", hbm_gb=16.0, host_dram_gb=512.0,
                   cxl_hw_gb=1024.0, base_usd=2250.0, power_kw=0.75),
    )
}


def get_server(name: str) -> ServerSpec:
    try:
        return SERVERS[name]
    except KeyError:
        raise KeyError(
            f"unknown server spec {name!r}; catalog: {sorted(SERVERS)}"
        ) from None


# ---------------------------------------------------------------------------
# Fleet telemetry summary (produced by BudgetArbiter.fleet_report)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetReport:
    """What the planner needs to know about a live multi-tenant run.

    All means are over the reported window range; per-window arrays are
    aligned to that range. Produced by ``BudgetArbiter.fleet_report()`` —
    the planner runs on live telemetry, not offline traces.
    """

    windows: int
    tenant_names: Tuple[str, ...]
    # Uncompressed footprint per tenant (bytes) — the all-DRAM demand.
    tenant_footprint_bytes: Tuple[float, ...]
    # Mean resident bytes per backing device per tenant (placement_hist x
    # stored_bytes, grouped by each tier's media device).
    tenant_bytes_by_device: Tuple[Dict[str, float], ...]
    # Mean decode demand per tenant (accesses per window).
    tenant_demand_accesses: Tuple[float, ...]
    # Mean SLA-weighted hotness-latency penalty per tenant (seconds).
    tenant_penalty_s: Tuple[float, ...]
    # Fleet latency proxy distribution: per-window sum of tenant penalties.
    per_window_penalty_s: np.ndarray
    fleet_tco_usd: float  # mean Eq. 12 byte-level TCO
    fleet_savings_pct: float  # mean Eq. 9-12 savings vs all-DRAM bytes
    # Mean migration + speculative bytes per window, per device (the
    # bandwidth demand the fleet imposes on each shared link).
    media_bytes_by_device: Dict[str, float]
    budget_feasible_frac: float
    # Fault/degradation totals over the reported range (zero on healthy
    # runs): injected stage retries, ring corruptions detected, cohorts
    # aborted on down devices, and windows with >= 1 quarantined device.
    fault_retries: int = 0
    payload_corruptions: int = 0
    aborted_cohorts: int = 0
    quarantine_windows: int = 0


# ---------------------------------------------------------------------------
# Tier-configuration search space
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """One searched tier configuration.

    ``family`` picks the tierset: ``2t`` is the production 2-tier baseline
    (threshold policy), ``6t`` the paper's 5-tier analytical config,
    ``split`` the serving KV tierset with a ``warm_bits``/``cold_bits``
    codec split (the class-major deployment axis), and ``cxl`` the 6-tier
    set that inserts the hardware-compressed CXL expander tier (X1) into
    the characterized ladder. ``fast_fraction`` caps the shared fast tier
    (placement 0) at that fraction of fleet regions; ``alpha`` is the
    arbiter/analytical perf-vs-TCO knob.
    """

    family: str  # "2t" | "6t" | "split" | "cxl"
    alpha: float = 0.5
    fast_fraction: float = 0.5
    warm_bits: int = 8
    cold_bits: int = 4

    @property
    def name(self) -> str:
        if self.family == "2t":
            return f"2t-f{self.fast_fraction:.2f}"
        if self.family == "split":
            return (
                f"split{self.warm_bits}{self.cold_bits}"
                f"-a{self.alpha:.2f}-f{self.fast_fraction:.2f}"
            )
        if self.family == "cxl":
            return f"cxl-a{self.alpha:.2f}-f{self.fast_fraction:.2f}"
        return f"6t-a{self.alpha:.2f}-f{self.fast_fraction:.2f}"


def default_search_grid() -> List[PlannerConfig]:
    """The default configuration sweep: the 2T production baseline plus the
    6T alpha ladder and the codec-split family at two fast-tier sizes."""
    grid: List[PlannerConfig] = [PlannerConfig("2t", fast_fraction=0.5)]
    for alpha in (0.9, 0.5, 0.1):
        for frac in (0.5, 0.25):
            grid.append(PlannerConfig("6t", alpha=alpha, fast_fraction=frac))
    for wb, cb in ((8, 4), (8, 8)):
        grid.append(
            PlannerConfig("split", alpha=0.5, fast_fraction=0.5,
                          warm_bits=wb, cold_bits=cb)
        )
    return grid


def cxl_search_grid() -> List[PlannerConfig]:
    """The CXL-expanded sweep: the default grid plus the ``cxl`` family's
    alpha ladder — the configurations only a ``cxl_hw``-equipped server can
    realize. Additive: the shared prefix keeps the 2T/6T/split points
    byte-comparable with the default-grid baselines."""
    grid = default_search_grid()
    for alpha in (0.9, 0.5, 0.1):
        for frac in (0.5, 0.25):
            grid.append(PlannerConfig("cxl", alpha=alpha, fast_fraction=frac))
    return grid


def build_arbiter(
    cfg: PlannerConfig,
    specs: Sequence,
    n_regions: int,
    region_bytes: int = 2 * 1024 * 1024,
    media_bw_budget_bytes: Optional[Dict[str, float]] = None,
):
    """Build a BudgetArbiter realizing one searched tier configuration."""
    from repro_torch.core.arbiter import BudgetArbiter

    n_t = len(specs)
    if cfg.family == "2t":
        managers = [make_manager("2T-M", n_regions, region_bytes=region_bytes,
                                 seed=t) for t in range(n_t)]
    elif cfg.family == "6t":
        managers = [
            make_manager(f"6T-AM-{cfg.alpha}", n_regions,
                         region_bytes=region_bytes, seed=t)
            for t in range(n_t)
        ]
    elif cfg.family == "split":
        # Lazy: serving/ imports torch and the kernel wrappers, core/ does not.
        from repro_torch.serving.kv_cache import kv_tierset

        ts = kv_tierset(2048, warm_bits=cfg.warm_bits, cold_bits=cfg.cold_bits)
        managers = [
            TierScapeManager(
                ts, n_regions, region_bytes,
                ManagerConfig(policy="analytical", alpha=cfg.alpha), seed=t,
            )
            for t in range(n_t)
        ]
    elif cfg.family == "cxl":
        managers = [
            make_manager(f"7T-CX-{cfg.alpha}", n_regions,
                         region_bytes=region_bytes, seed=t)
            for t in range(n_t)
        ]
    else:
        raise ValueError(f"unknown planner family {cfg.family!r}")
    n_opts = managers[0].tierset.n_tiers + 1
    cap = np.full(n_opts, float(n_t * n_regions))
    cap[0] = max(cfg.fast_fraction * n_t * n_regions, 1.0)
    return BudgetArbiter(
        specs, managers, alpha=cfg.alpha, tier_capacity_regions=cap,
        media_bw_budget_bytes=media_bw_budget_bytes,
    )


def simulate_and_report(
    cfg: PlannerConfig,
    workloads_fn: Callable[[], List],
    specs: Sequence,
    windows: int = 16,
    warmup_windows: int = 2,
    seed: int = 0,
    n_regions: Optional[int] = None,
) -> FleetReport:
    """Run one configuration through ``simulate_multitenant`` and summarize
    it as the FleetReport the planner consumes — live telemetry, not an
    offline trace."""
    from repro_torch.core import simulator

    workloads = workloads_fn()
    n = n_regions if n_regions is not None else workloads[0].n_regions
    arb = build_arbiter(cfg, specs, n)
    simulator.simulate_multitenant(
        workloads, arb, windows=windows, warmup_windows=warmup_windows,
        seed=seed, prefetch=False,
    )
    return arb.fleet_report(last_windows=windows - warmup_windows)


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FrontierPoint:
    """One evaluated configuration: a perf-per-dollar point."""

    config: str
    servers: int
    fleet_usd: float  # amortized server dollars over the operating period
    memory_tco_usd: float  # Eq. 12 byte-level TCO (mean, per tenant cell)
    savings_pct: float  # fleet $ savings vs the all-DRAM-provisioned fleet
    p50_penalty_s: float  # latency proxy: median per-window fleet penalty
    p99_penalty_s: float  # latency proxy: p99 per-window fleet penalty
    perf_per_dollar: float  # served decode demand per amortized dollar

    def to_dict(self) -> Dict[str, float]:
        return {
            "config": self.config,
            "servers": int(self.servers),
            "fleet_usd": _r(self.fleet_usd),
            "memory_tco_usd": _r(self.memory_tco_usd),
            "savings_pct": _r(self.savings_pct),
            "p50_penalty_s": _r(self.p50_penalty_s),
            "p99_penalty_s": _r(self.p99_penalty_s),
            "perf_per_dollar": _r(self.perf_per_dollar),
        }


class CapacityPlanner:
    """Bin-packs fleet demand onto servers and prices tier configurations.

    ``fleet_scale`` replicates the reported tenant mix that many times: the
    report describes one tenant cell (the simulated mix); a fleet serves
    many identical cells, which is what makes server-count quantization
    fine-grained enough for the savings axis to be meaningful.
    """

    def __init__(
        self,
        server: ServerSpec,
        operating_period_years: float = 3.0,
        fleet_scale: int = 256,
    ):
        if fleet_scale < 1:
            raise ValueError("fleet_scale must be >= 1")
        self.server = server
        self.operating_period_years = operating_period_years
        self.fleet_scale = fleet_scale

    # ------------------------------------------------------------- packing
    def _tenant_demands(self, report: FleetReport) -> List[Dict[str, float]]:
        """Per-tenant demand vectors (one tenant cell, not yet scaled)."""
        out = []
        for t in range(len(report.tenant_names)):
            d: Dict[str, float] = {}
            for dev, b in sorted(report.tenant_bytes_by_device[t].items()):
                if b > 0:
                    d[MEM + dev] = float(b)
            d[DECODE] = float(report.tenant_demand_accesses[t])
            # Migration traffic is a fleet aggregate; attribute it evenly
            # across tenants (the arbiter already reconciled who moves).
            n_t = len(report.tenant_names)
            for dev, b in sorted(report.media_bytes_by_device.items()):
                if b > 0:
                    d[BW + dev] = float(b) / n_t
            out.append(d)
        return out

    def _dram_demands(self, report: FleetReport) -> List[Dict[str, float]]:
        """The all-DRAM-provisioned reference: every tenant's full footprint
        resides uncompressed in accelerator-attached memory, no migration
        traffic (nothing is ever compressed or moved)."""
        return [
            {
                MEM + "hbm": float(report.tenant_footprint_bytes[t]),
                DECODE: float(report.tenant_demand_accesses[t]),
            }
            for t in range(len(report.tenant_names))
        ]

    def pack(self, demands: Sequence[Dict[str, float]]) -> int:
        """First-fit-decreasing bin-pack of demand vectors onto servers.

        Deterministic: tenants are ordered by (max capacity fraction,
        tenant index) descending-first; a tenant whose demand exceeds one
        server in any dimension is split into equal shards first (tenant
        sharding). Returns the number of servers needed.
        """
        cap = self.server.capacity_vector()

        def frac(d: Dict[str, float]) -> float:
            f = 0.0
            for k, v in d.items():
                if v <= 0:
                    continue
                if cap.get(k, 0.0) <= 0:
                    raise ValueError(
                        f"server {self.server.name!r} has no capacity for "
                        f"demand dimension {k!r}"
                    )
                f = max(f, v / cap[k])
            return f

        shards: List[Tuple[float, int, Dict[str, float]]] = []
        for i, d in enumerate(demands):
            f = frac(d)
            n_shards = max(int(np.ceil(f)), 1)
            shard = {k: v / n_shards for k, v in d.items()}
            for _ in range(n_shards):
                shards.append((frac(shard), i, shard))
        # Largest shard first; ties by original tenant index then insertion.
        shards.sort(key=lambda s: (-s[0], s[1]))

        free: List[Dict[str, float]] = []  # remaining capacity per open server
        for _, _, d in shards:
            placed = False
            for f in free:
                if all(d.get(k, 0.0) <= f[k] + 1e-9 for k in cap):
                    for k in cap:
                        f[k] -= d.get(k, 0.0)
                    placed = True
                    break
            if not placed:
                f = dict(cap)
                for k in cap:
                    f[k] -= d.get(k, 0.0)
                free.append(f)
        return len(free)

    # ------------------------------------------------------------- pricing
    def _scale(self, demands: Sequence[Dict[str, float]]) -> List[Dict[str, float]]:
        return [d for _ in range(self.fleet_scale) for d in demands]

    def evaluate(self, config_name: str, report: FleetReport) -> FrontierPoint:
        """Price one configuration's report as a frontier point."""
        servers = self.pack(self._scale(self._tenant_demands(report)))
        dram_servers = self.pack(self._scale(self._dram_demands(report)))
        per_server = self.server.amortized_usd(self.operating_period_years)
        fleet_usd = servers * per_server
        dram_usd = dram_servers * per_server
        demand = self.fleet_scale * float(sum(report.tenant_demand_accesses))
        pen = np.asarray(report.per_window_penalty_s, dtype=np.float64)
        return FrontierPoint(
            config=config_name,
            servers=servers,
            fleet_usd=fleet_usd,
            memory_tco_usd=report.fleet_tco_usd,
            savings_pct=(
                100.0 * (dram_usd - fleet_usd) / dram_usd if dram_usd > 0 else 0.0
            ),
            p50_penalty_s=float(np.percentile(pen, 50)) if pen.size else 0.0,
            p99_penalty_s=float(np.percentile(pen, 99)) if pen.size else 0.0,
            perf_per_dollar=demand / fleet_usd if fleet_usd > 0 else 0.0,
        )

    # ------------------------------------------------------------ frontier
    @staticmethod
    def pareto_frontier(points: Sequence[FrontierPoint]) -> List[FrontierPoint]:
        """Non-dominated subset: minimize p99 latency proxy, maximize
        savings. Sorted by latency ascending; deterministic tie-breaks."""
        ordered = sorted(
            points, key=lambda p: (p.p99_penalty_s, -p.savings_pct, p.config)
        )
        out: List[FrontierPoint] = []
        best = -np.inf
        for p in ordered:
            if p.savings_pct > best + 1e-12:
                out.append(p)
                best = p.savings_pct
        return out

    @staticmethod
    def frontier_monotone(frontier: Sequence[FrontierPoint]) -> bool:
        """A valid frontier trades latency for dollars monotonically:
        sorted by latency proxy ascending, savings strictly increase and
        fleet dollars never increase."""
        for a, b in zip(frontier, frontier[1:]):
            if b.p99_penalty_s < a.p99_penalty_s - 1e-12:
                return False
            if b.savings_pct <= a.savings_pct + 1e-12:
                return False
            if b.fleet_usd > a.fleet_usd + 1e-9:
                return False
        return True

    @staticmethod
    def dominance_margin_pct(
        frontier: Sequence[FrontierPoint],
        baseline: FrontierPoint,
        latency_tol: float = 1.05,
    ) -> float:
        """Savings-points margin by which the frontier dominates
        ``baseline``: the best savings of any frontier point whose latency
        proxy is no worse than the baseline's (x ``latency_tol``), minus
        the baseline's savings. Negative = no dominating point."""
        margins = [
            p.savings_pct - baseline.savings_pct
            for p in frontier
            if p.p99_penalty_s <= baseline.p99_penalty_s * latency_tol + 1e-12
        ]
        return max(margins) if margins else -np.inf


# ---------------------------------------------------------------------------
# Sweep driver
# ---------------------------------------------------------------------------


def sweep_frontier(
    workloads_fn: Callable[[], List],
    specs: Sequence,
    planner: CapacityPlanner,
    configs: Optional[Sequence[PlannerConfig]] = None,
    windows: int = 16,
    warmup_windows: int = 2,
    seed: int = 0,
) -> Dict:
    """Evaluate every configuration and emit the frontier summary dict
    (JSON-ready, deterministic for a fixed seed)."""
    configs = list(configs) if configs is not None else default_search_grid()
    points: List[FrontierPoint] = []
    baseline_2t: Optional[FrontierPoint] = None
    for cfg in configs:
        report = simulate_and_report(
            cfg, workloads_fn, specs, windows=windows,
            warmup_windows=warmup_windows, seed=seed,
        )
        point = planner.evaluate(cfg.name, report)
        points.append(point)
        if cfg.family == "2t" and baseline_2t is None:
            baseline_2t = point
    frontier = planner.pareto_frontier(points)
    out: Dict = {
        "server": planner.server.name,
        "operating_period_years": _r(planner.operating_period_years),
        "fleet_scale": planner.fleet_scale,
        "windows": windows,
        "seed": seed,
        "points": [p.to_dict() for p in points],
        "frontier": [p.to_dict() for p in frontier],
        "monotone": planner.frontier_monotone(frontier),
    }
    if baseline_2t is not None:
        margin = planner.dominance_margin_pct(frontier, baseline_2t)
        out["baseline_2t"] = baseline_2t.to_dict()
        out["dominance_margin_pct"] = _r(margin) if np.isfinite(margin) else None
        out["dominates_2t"] = bool(margin > 0)
    return out


def frontier_json(result: Dict) -> str:
    """Canonical JSON encoding (the byte-reproducibility contract)."""
    return json.dumps(result, indent=2, sort_keys=True)
