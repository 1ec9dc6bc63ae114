"""The port's planning stack against the JAX package's, on the CPU: the
trace-driven window simulator, the multi-tenant ``BudgetArbiter`` and the
fleet ``CapacityPlanner``.

Both packages run the same numpy float64 control plane on the same RNG
streams, so every result must be equal exactly, floats too: each
``SimResult`` field, every window's ``ArbiterWindowStats`` with its tenants'
allotted budgets, placements and ledger usage, and the frontier JSON byte
for byte. The one input that is not a function of the seed is the daemon's
wall clock (``time.perf_counter`` in ``core/manager.py``, behind
``daemon_tax_pct``): the exact comparisons give both packages' managers the
same counting clock (``same_clock``). The claims of the reference's own
tests (``tests/test_capacity.py``, the simulator claims of
``tests/test_system.py``, the arbiter and simulator tests of
``tests/test_media.py`` and ``tests/test_prefetch.py``) are run on the port,
with its values compared to the reference's.
"""

import contextlib
import dataclasses
import importlib.util
import io
import itertools
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from proptest import cases, draw_float, draw_int  # noqa: E402
from repro.core import arbiter as jarbiter  # noqa: E402
from repro.core import capacity as jcapacity  # noqa: E402
from repro.core import manager as jmanager  # noqa: E402
from repro.core import simulator as jsimulator  # noqa: E402
from repro.core import tco as jtco  # noqa: E402
from repro.core import telemetry as jtelemetry  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro_torch.core import (  # noqa: E402
    arbiter, capacity, manager, simulator, tco, telemetry, tiers,
)

REF = types.SimpleNamespace(sim=jsimulator, arb=jarbiter, man=jmanager, cap=jcapacity,
                            tco=jtco, tel=jtelemetry, tiers=jtiers)
PORT = types.SimpleNamespace(sim=simulator, arb=arbiter, man=manager, cap=capacity,
                             tco=tco, tel=telemetry, tiers=tiers)
PKGS = (REF, PORT)
ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def same_clock():
    """Give both packages' managers a counting clock (one 0.1 ms tick per
    read), so daemon seconds depend only on the calls made."""
    with pytest.MonkeyPatch.context() as mp:
        for pkg in PKGS:
            tick = itertools.count()
            mp.setattr(pkg.man, "time", types.SimpleNamespace(
                perf_counter=lambda tick=tick: next(tick) * 1e-4))
        yield


def assert_same(a, b, path="result"):
    """Recursive exact equality across the two packages' result types."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b), (path, type(a), type(b))
        assert a == b or (a != a and b != b), (path, a, b)


# ---------------------------------------------------------------------------
# the window simulator: every generator, with and without prefetch and
# contention pricing
# ---------------------------------------------------------------------------

GENERATORS = {
    "gaussian_kv": lambda s: s.gaussian_kv(n_regions=256, accesses_per_window=20_000,
                                           drift_frac=0.05),
    "rotating_frontier": lambda s: s.rotating_frontier(n_regions=256,
                                                       accesses_per_window=20_000),
    "uniform_scan": lambda s: s.uniform_scan(n_regions=256, accesses_per_window=20_000),
    "bursty_kv": lambda s: s.bursty_kv(n_regions=256, accesses_per_window=20_000,
                                       burst_every=4, burst_windows=1),
    "skew_flip": lambda s: s.skew_flip(n_regions=256, accesses_hot=20_000,
                                       accesses_cold=2_000, flip_window=4),
}
SIM_MODES = {
    "plain": {},
    "prefetch": dict(prefetch=True),
    "priced": dict(price_media_contention=True),
    "prefetch_priced": dict(prefetch=True, price_media_contention=True),
}


def _simulate_both(make_wl, config, n_regions, windows=8, seed=1, line_ratio=None, **kw):
    out = []
    with same_clock():
        for pkg in PKGS:
            wl = make_wl(pkg.sim)
            if line_ratio is not None:
                wl = dataclasses.replace(wl, line_ratio=line_ratio)
            m = pkg.man.make_manager(config, n_regions, thresholds={"C": 50.0, "M": 200.0,
                                                                    "A": 800.0})
            out.append(pkg.sim.simulate(wl, m, windows=windows, seed=seed, **kw))
    return out


@pytest.mark.parametrize("mode", sorted(SIM_MODES))
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_simulate_matches_reference(gen, mode):
    ref, port = _simulate_both(GENERATORS[gen], "6T-AM-0.5", 256, **SIM_MODES[mode])
    assert_same(ref, port)
    assert port.windows == 8 and port.placement_hists.shape == (8, 6)
    if "prefetch" in mode and gen != "uniform_scan":
        assert port.prefetch_bytes > 0


@pytest.mark.parametrize("config", ["2T-M", "6T-WF-M", "7T-CX-0.5"])
def test_simulate_policies_and_adaptive_media_match_reference(config):
    """The threshold policies, and the ``cxl_hw`` tier whose adaptive device
    takes the workload's line ratio at every boundary."""
    ref, port = _simulate_both(GENERATORS["gaussian_kv"], config, 256, windows=10,
                               line_ratio=1.55, prefetch=True)
    assert_same(ref, port)
    if config.startswith("7T"):
        assert "cxl_hw" in port.media_bytes_by_device


@pytest.mark.parametrize("i", range(5))
def test_paper_workloads_match_reference(i):
    """``PAPER_WORKLOADS()`` at its own sizes (4096-16384 regions, 2M
    accesses a window), four windows."""
    def make(s):
        return s.PAPER_WORKLOADS()[i]
    ref, port = _simulate_both(make, "6T-AM-0.5", make(simulator).n_regions, windows=4)
    assert_same(ref, port)
    assert port.workload == jsimulator.PAPER_WORKLOADS()[i].name


# ---------------------------------------------------------------------------
# multi-tenant simulation: benchmarks/multitenant.py's scenarios
# ---------------------------------------------------------------------------

MT_N, MT_ACC, MT_WINDOWS = 512, 200_000, 12


def _scenario(pkg, name):
    s, spec, n = pkg.sim, pkg.arb.TenantSpec, MT_N
    if name == "hotcold":
        return ([s.gaussian_kv(n_regions=n, accesses_per_window=MT_ACC, sigma_frac=0.08,
                               name="hot"),
                 s.uniform_scan(n_regions=n, accesses_per_window=MT_ACC // 10,
                                compute_s_per_window=1.0, name="cold")],
                [spec("hot", sla_weight=1.0), spec("cold", sla_weight=1.0, alpha_floor=0.05)])
    if name == "bursty":
        return ([s.bursty_kv(n_regions=n, accesses_per_window=MT_ACC // 4, burst_every=8,
                             burst_windows=2, burst_mult=8.0, name="bursty"),
                 s.gaussian_kv(n_regions=n, accesses_per_window=MT_ACC, sigma_frac=0.12,
                               name="steady")],
                [spec("bursty", sla_weight=2.0), spec("steady", sla_weight=1.0)])
    return ([s.skew_flip(n_regions=n, accesses_hot=MT_ACC, accesses_cold=MT_ACC // 10,
                         flip_window=6, hot_first=first, name=nm)
             for first, nm in ((True, "early"), (False, "late"))],
            [spec("early", sla_weight=1.0), spec("late", sla_weight=1.0)])


def _watch(arb):
    """Snapshot placements and ledger usage after every ``end_window``."""
    snaps = []
    end = arb.end_window

    def end_window():
        plans = end()
        snaps.append(([m.placement.copy() for m in arb.managers], arb.ledger.usage.copy(),
                      {k: dataclasses.asdict(p) for k, p in plans.items()}))
        return plans
    arb.end_window = end_window
    return snaps


@pytest.mark.parametrize("config", ["6t", "2t"])
@pytest.mark.parametrize("scenario", ["hotcold", "bursty", "skewflip"])
def test_simulate_multitenant_matches_reference(scenario, config):
    name = "6T-AM-0.5" if config == "6t" else "2T-M"
    runs = []
    with same_clock():
        for pkg in PKGS:
            wls, specs = _scenario(pkg, scenario)
            managers = [pkg.man.make_manager(name, MT_N, seed=t) for t in range(2)]
            cap = np.full(managers[0].tierset.n_tiers + 1, 2.0 * MT_N)
            cap[0] = MT_N
            arb = pkg.arb.BudgetArbiter(specs, managers, alpha=0.5, tier_capacity_regions=cap)
            snaps = _watch(arb)
            res = pkg.sim.simulate_multitenant(wls, arb, windows=MT_WINDOWS, warmup_windows=2,
                                               seed=0)
            single = pkg.sim.simulate_single_tenant_baseline(
                wls, pkg.man.make_manager(name, 2 * MT_N, seed=0), windows=MT_WINDOWS,
                warmup_windows=2, seed=0)
            runs.append((res, arb, snaps, single))
    (jres, jarb, jsnaps, jsingle), (res, arb, snaps, single) = runs
    assert_same(jres, res)
    assert len(arb.history) == MT_WINDOWS
    for w, (jws, ws) in enumerate(zip(jarb.history, arb.history)):
        assert_same(jws, ws, f"window {w}")
    for w, ((jpl, jusage, jplans), (pl, usage, plans)) in enumerate(zip(jsnaps, snaps)):
        for t in range(2):
            np.testing.assert_array_equal(pl[t], jpl[t], err_msg=f"window {w} tenant {t}")
        np.testing.assert_array_equal(usage, jusage, err_msg=f"window {w} ledger")
        assert_same(jplans, plans, f"window {w} plans")
    np.testing.assert_array_equal(arb.ledger.reserved, jarb.ledger.reserved)
    assert single == jsingle
    assert abs(res.fleet_savings_pct - single) <= 5.0 or config == "2t"


# ---------------------------------------------------------------------------
# the capacity frontier, byte for byte
# ---------------------------------------------------------------------------


def _frontier(pkg, grid, server, line_ratios=None):
    """``benchmarks/capacity_frontier.py``'s sweep (512 regions, 200k/20k
    accesses, 16 windows, warmup 2, flip at 8, 3 years, fleet scale 256,
    seed 0); ``line_ratios`` gives the tenants' data a line ratio on the
    ``cxl_hw`` expander."""
    def workloads():
        wls = [pkg.sim.skew_flip(n_regions=512, accesses_hot=200_000, accesses_cold=20_000,
                                 flip_window=8, hot_first=first, name=nm)
               for first, nm in ((True, "early"), (False, "late"))]
        if line_ratios:
            wls = [dataclasses.replace(w, line_ratio=r) for w, r in zip(wls, line_ratios)]
        return wls
    specs = [pkg.arb.TenantSpec("early", sla_weight=1.0),
             pkg.arb.TenantSpec("late", sla_weight=1.0)]
    planner = pkg.cap.CapacityPlanner(pkg.cap.get_server(server), operating_period_years=3.0,
                                      fleet_scale=256)
    return pkg.cap.sweep_frontier(workloads, specs, planner, configs=grid(pkg.cap),
                                  windows=16, warmup_windows=2, seed=0)


@pytest.mark.parametrize("grid", ["default", "cxl"])
def test_frontier_json_byte_equal_to_reference(grid):
    if grid == "default":
        args = (lambda c: c.default_search_grid(), "v5e-base")
    else:
        args = (lambda c: c.cxl_search_grid(), "v5e-cxlhw", (1.55, 1.02))
    ref, port = (_frontier(pkg, *args) for pkg in PKGS)
    js = capacity.frontier_json(port)
    assert js == jcapacity.frontier_json(ref)
    assert port["monotone"] is True
    assert port["dominates_2t"] is True and port["dominance_margin_pct"] >= 22.0
    assert len(port["points"]) == (9 if grid == "default" else 15)


# ---------------------------------------------------------------------------
# tests/test_capacity.py on the port, values compared with the reference's
# ---------------------------------------------------------------------------


def test_tco_ordering_random_placements():
    for i, rng in cases(40):
        n = draw_int(rng, 1, 512)
        region_bytes = draw_int(rng, 1, 64) * 4096
        ratios = None
        seed = draw_int(rng, 0, 1 << 30)
        if draw_int(rng, 0, 1):
            ratios = [draw_float(rng, 1.0, 40.0) for _ in range(5)]
        vals = []
        for pkg in PKGS:
            ts = pkg.tiers.default_tierset(2048)
            placement = np.random.default_rng(seed).integers(0, ts.n_tiers + 1, size=n)
            mn = pkg.tco.tco_min(ts, n, region_bytes, ratios)
            mx = pkg.tco.tco_max(n, region_bytes)
            nt = pkg.tco.tco_nt(ts, placement, region_bytes, ratios)
            s = pkg.tco.savings_pct(ts, placement, region_bytes, ratios)
            assert mn <= nt + 1e-9 and nt <= mx + 1e-9, (i, mn, nt, mx)
            assert -1e-9 <= s <= 100.0 + 1e-9, (i, s)
            vals.append((mn, mx, nt, s))
        assert vals[0] == vals[1], i


def test_budget_monotone_in_alpha():
    for i, rng in cases(25):
        n = draw_int(rng, 1, 256)
        region_bytes = draw_int(rng, 1, 64) * 4096
        alphas = sorted(draw_float(rng, 0.0, 1.0) for _ in range(4))
        got = []
        for pkg in PKGS:
            ts = pkg.tiers.default_tierset(2048)
            b = [pkg.tco.budget(ts, n, region_bytes, a) for a in alphas]
            assert all(b0 <= b1 + 1e-9 for b0, b1 in zip(b, b[1:])), (i, alphas, b)
            got.append(b)
        assert got[0] == got[1], i
    ts = tiers.default_tierset(2048)
    assert tco.budget(ts, 64, 4096, 0.0) == pytest.approx(tco.tco_min(ts, 64, 4096))
    assert tco.budget(ts, 64, 4096, 1.0) == pytest.approx(tco.tco_max(64, 4096))


def test_zero_region_and_empty_fleet_save_nothing():
    ts = tiers.default_tierset(2048)
    assert tco.savings_pct(ts, np.zeros(0, dtype=np.int64), 4096) == 0.0
    assert tco.fleet_tco_usd([]) == 0.0
    assert tco.fleet_savings_pct([]) == 0.0
    assert tco.fleet_savings_pct(iter([])) == 0.0


def test_server_catalog_costs_and_capacity_vectors_match_reference():
    assert list(capacity.SERVERS) == list(jcapacity.SERVERS)
    for name, s in capacity.SERVERS.items():
        j = jcapacity.get_server(name)
        assert dataclasses.asdict(s) == dataclasses.asdict(j), name
        assert s.purchase_usd() == j.purchase_usd()
        assert s.capacity_vector() == j.capacity_vector()
        for years in (1.0, 3.0, 5.0):
            assert s.amortized_usd(years) == j.amortized_usd(years)
    s = capacity.get_server("v5e-base")
    years = 3.0
    purchase = s.purchase_usd()
    expected = (purchase + s.deployment_usd
                + s.annual_maintenance_pct / 100.0 * purchase * years
                + s.rack_usd_per_year * years
                + s.power_kw * 24.0 * 365.0 * years * s.usd_per_kwh)
    assert s.amortized_usd(years) == pytest.approx(expected)
    assert s.amortized_usd(5.0) > s.amortized_usd(years) > purchase
    base = s.capacity_vector()
    assert base[capacity.MEM + "hbm"] == 16.0 * capacity.GIB
    assert capacity.MEM + "cxl" not in base
    cxl = capacity.get_server("v5e-cxl").capacity_vector()
    assert cxl[capacity.MEM + "cxl"] == 1024.0 * capacity.GIB and capacity.BW + "cxl" in cxl
    with pytest.raises(ValueError):
        s.amortized_usd(0.0)
    with pytest.raises(KeyError):
        capacity.get_server("nope")


def test_pack_bounds_random_demands_match_reference():
    def planner(cap_mod):
        server = cap_mod.ServerSpec("t", hbm_gb=1.0, host_dram_gb=4.0,
                                    decode_accesses_per_window=1e6)
        return cap_mod.CapacityPlanner(server, fleet_scale=1), server.capacity_vector()
    (jp, _), (p, cap) = planner(jcapacity), planner(capacity)
    hbm, dec = capacity.MEM + "hbm", capacity.DECODE
    for i, rng in cases(30):
        demands = [{hbm: draw_float(rng, 0.0, 2.5) * cap[hbm],
                    dec: draw_float(rng, 0.0, 1.5) * cap[dec]}
                   for _ in range(draw_int(rng, 1, 12))]
        servers = p.pack(demands)
        assert servers == jp.pack(demands), i
        lower = max(int(np.ceil(sum(d[k] for d in demands) / cap[k])) for k in (hbm, dec))
        shards = sum(max(int(np.ceil(max(v / cap[k] for k, v in d.items()))), 1)
                     for d in demands)
        assert lower <= servers <= shards, (i, lower, servers, shards)


def test_pack_shards_oversized_tenant():
    for cap_mod in (capacity, jcapacity):
        planner = cap_mod.CapacityPlanner(cap_mod.ServerSpec("t", hbm_gb=1.0, host_dram_gb=1.0),
                                          fleet_scale=1)
        assert planner.pack([{cap_mod.MEM + "hbm": 3.5 * cap_mod.GIB}]) == 4
        assert planner.pack([{cap_mod.MEM + "hbm": 0.25 * cap_mod.GIB}
                             for _ in range(8)]) == 2
        with pytest.raises(ValueError):
            planner.pack([{cap_mod.BW + "nvme": 1.0}])


def _pt(cap_mod, name, savings, p99, usd=100.0):
    return cap_mod.FrontierPoint(config=name, servers=1, fleet_usd=usd, memory_tco_usd=0.0,
                                 savings_pct=savings, p50_penalty_s=p99 / 2,
                                 p99_penalty_s=p99, perf_per_dollar=1.0)


def test_pareto_frontier_and_dominance_match_reference():
    for i, rng in cases(30):
        raw = [(f"c{j}", draw_float(rng, 0.0, 80.0), draw_float(rng, 0.0, 10.0),
                draw_float(rng, 10.0, 100.0)) for j in range(draw_int(rng, 1, 16))]
        pts = [_pt(capacity, n, s, p, u) for n, s, p, u in raw]
        front = capacity.CapacityPlanner.pareto_frontier(pts)
        jfront = jcapacity.CapacityPlanner.pareto_frontier(
            [_pt(jcapacity, n, s, p, u) for n, s, p, u in raw])
        assert [f.to_dict() for f in front] == [f.to_dict() for f in jfront], i
        assert front, i
        for a, b in zip(front, front[1:]):
            assert a.p99_penalty_s <= b.p99_penalty_s + 1e-12 and b.savings_pct > a.savings_pct
        for p in pts:
            for f in front:
                assert not (p.savings_pct > f.savings_pct + 1e-9
                            and p.p99_penalty_s < f.p99_penalty_s - 1e-9), (i, p, f)
        assert (capacity.CapacityPlanner.frontier_monotone(front)
                == jcapacity.CapacityPlanner.frontier_monotone(jfront))
    for cap_mod in (capacity, jcapacity):
        base = _pt(cap_mod, "2t", 20.0, 1.0)
        front = [_pt(cap_mod, "a", 30.0, 0.5), _pt(cap_mod, "b", 50.0, 2.0)]
        assert cap_mod.CapacityPlanner.dominance_margin_pct(front, base) == pytest.approx(10.0)
        assert cap_mod.CapacityPlanner.dominance_margin_pct(
            [_pt(cap_mod, "c", 90.0, 99.0)], base) == -np.inf


def _tiny_workloads(pkg):
    return lambda: [pkg.sim.skew_flip(n_regions=128, accesses_hot=50_000, accesses_cold=5_000,
                                      flip_window=4, hot_first=first, name=nm)
                    for first, nm in ((True, "early"), (False, "late"))]


def _tiny_specs(pkg):
    return [pkg.arb.TenantSpec("early", sla_weight=1.0),
            pkg.arb.TenantSpec("late", sla_weight=1.0)]


def test_planner_tiny_sweep_deterministic_and_equal_to_reference():
    def sweep(pkg):
        planner = pkg.cap.CapacityPlanner(pkg.cap.get_server("v5e-base"), fleet_scale=64)
        grid = [pkg.cap.PlannerConfig("2t", fast_fraction=0.5),
                pkg.cap.PlannerConfig("6t", alpha=0.5, fast_fraction=0.5),
                pkg.cap.PlannerConfig("split", alpha=0.5, fast_fraction=0.5)]
        return pkg.cap.frontier_json(pkg.cap.sweep_frontier(
            _tiny_workloads(pkg), _tiny_specs(pkg), planner, configs=grid, windows=8,
            warmup_windows=2, seed=7))
    a, b = sweep(PORT), sweep(PORT)
    assert a == b == sweep(REF)
    import json
    res = json.loads(a)
    assert [p["config"] for p in res["points"]] == [
        "2t-f0.50", "6t-a0.50-f0.50", "split84-a0.50-f0.50"]
    for p in res["points"]:
        assert p["servers"] >= 1 and p["fleet_usd"] > 0
        assert p["p50_penalty_s"] <= p["p99_penalty_s"] + 1e-12
    assert res["monotone"] is True and res["baseline_2t"]["config"] == "2t-f0.50"
    names = {p["config"] for p in res["points"]}
    assert all(p["config"] in names for p in res["frontier"])


def test_fleet_report_and_planner_point_match_reference():
    out = []
    for pkg in PKGS:
        cfg = pkg.cap.PlannerConfig("6t", alpha=0.5, fast_fraction=0.5)
        report = pkg.cap.simulate_and_report(cfg, _tiny_workloads(pkg), _tiny_specs(pkg),
                                             windows=8, warmup_windows=2, seed=7)
        planner = pkg.cap.CapacityPlanner(pkg.cap.get_server("v5e-base"), fleet_scale=64)
        out.append((report, planner.evaluate(cfg.name, report)))
    (jreport, jpoint), (report, point) = out
    assert_same(jreport, report)
    assert point.to_dict() == jpoint.to_dict()
    assert report.windows == 6 and report.tenant_names == ("early", "late")
    assert report.per_window_penalty_s.shape == (6,)
    for t in range(2):
        assert report.tenant_footprint_bytes[t] == 128 * 2 * 1024 * 1024
        resident = sum(report.tenant_bytes_by_device[t].values())
        assert 0 < resident <= report.tenant_footprint_bytes[t] + 1e-6
        assert report.tenant_demand_accesses[t] > 0
    assert 0.0 <= report.budget_feasible_frac <= 1.0
    assert point.servers >= 1 and 0.0 <= point.savings_pct <= 100.0


# ---------------------------------------------------------------------------
# tests/test_system.py's simulator claims on the port
# ---------------------------------------------------------------------------

THRESHOLDS = {"C": 50.0, "M": 200.0, "A": 800.0}
SYSTEM_RUNS = ("2T-M", "2T-A", "6T-WF-C", "6T-WF-M", "6T-WF-A", "6T-AM-0.9", "6T-AM-0.5",
               "6T-AM-0.1", "6T-WF-M+pebs")


@pytest.fixture(scope="module")
def system_runs():
    """Every run the claims need, on both packages (2048 regions, 500k
    accesses, 16 windows, seed 1), under the counting clock."""
    out = {}
    with same_clock():
        for key in SYSTEM_RUNS:
            cfg, _, pebs = key.partition("+")
            pair = []
            for pkg in PKGS:
                noise = pkg.tel.PEBSNoise(sample_rate=0.02, misattribution=0.05) if pebs else None
                wl = pkg.sim.gaussian_kv(n_regions=2048, accesses_per_window=500_000)
                m = pkg.man.make_manager(cfg, 2048, thresholds=THRESHOLDS, pebs=noise)
                pair.append(pkg.sim.simulate(wl, m, windows=16, seed=1))
            out[key] = pair
    return out


@pytest.mark.parametrize("key", SYSTEM_RUNS)
def test_system_runs_match_reference(system_runs, key):
    ref, port = system_runs[key]
    assert_same(ref, port)


def test_ntier_dominates_2tier_and_tail_latency(system_runs):
    port = {k: v[1] for k, v in system_runs.items()}
    for level in ("M", "A"):
        r2, r6 = port[f"2T-{level}"], port[f"6T-WF-{level}"]
        assert r6.tco_savings_pct > r2.tco_savings_pct + 5
        assert r6.slowdown_pct <= r2.slowdown_pct * 1.25
    assert port["6T-WF-A"].p99_access_us <= port["2T-A"].p99_access_us + 1e-9


def test_analytical_alpha_tradeoff(system_runs):
    r9, r5, r1 = (system_runs[f"6T-AM-{a}"][1] for a in ("0.9", "0.5", "0.1"))
    assert r9.tco_savings_pct <= r5.tco_savings_pct <= r1.tco_savings_pct
    assert r9.slowdown_pct <= r5.slowdown_pct + 1e-6
    assert r5.slowdown_pct <= r1.slowdown_pct + 1e-6


def test_waterfall_tolerates_pebs_noise_and_shifts_placement(system_runs):
    clean, noisy = system_runs["6T-WF-M"][1], system_runs["6T-WF-M+pebs"][1]
    assert abs(noisy.tco_savings_pct - clean.tco_savings_pct) < 10
    assert noisy.slowdown_pct < clean.slowdown_pct * 2 + 2.0
    rc, ra = system_runs["6T-WF-C"][1], system_runs["6T-WF-A"][1]
    assert ra.placement_hists[-1][0] < rc.placement_hists[-1][0]


def test_daemon_tax_single_digit():
    """Paper §7.7 on the port's own wall clock (not compared: it is a time)."""
    wl = simulator.gaussian_kv(n_regions=2048, accesses_per_window=500_000)
    for cfg in ("6T-WF-M", "6T-AM-0.5"):
        m = manager.make_manager(cfg, 2048, thresholds=THRESHOLDS)
        assert simulator.simulate(wl, m, windows=16, seed=1).daemon_tax_pct < 10.0


# ---------------------------------------------------------------------------
# tests/test_media.py and tests/test_prefetch.py: arbiter and simulator
# ---------------------------------------------------------------------------


def _drive_arbiter(pkg, budget=None, spec_bytes=None, windows=3, n_regions=64, seed=0):
    managers = [pkg.man.make_manager("6T-AM-0.5", n_regions) for _ in range(2)]
    arb = pkg.arb.BudgetArbiter([pkg.arb.TenantSpec("a", sla_weight=2.0),
                                 pkg.arb.TenantSpec("b")], managers, alpha=0.5,
                                media_bw_budget_bytes=budget)
    rng = np.random.default_rng(seed)
    for _ in range(windows):
        for m in managers:
            counts = np.zeros(n_regions)
            hot = rng.choice(n_regions, size=8, replace=False)
            counts[hot] = rng.integers(100, 1000, 8)
            m.record_access_counts(counts)
        if spec_bytes:
            arb.record_speculative_bytes(spec_bytes)
        arb.end_window()
    return arb


def _drive_both(**kw):
    jarb, arb = (_drive_arbiter(pkg, **kw) for pkg in PKGS)
    assert_same(jarb.history, arb.history)
    return arb


def test_arbiter_defers_moves_when_device_bandwidth_saturates():
    free = _drive_both()
    assert all(ws.deferred_migrations == 0 for ws in free.history)
    peak = max(ws.media_bytes_by_device.get("host_dram_pcie", 0) for ws in free.history)
    assert peak > 0
    capped = _drive_both(budget={"host_dram_pcie": peak / 8})
    assert any(ws.deferred_migrations > 0 for ws in capped.history)
    for ws in capped.history:
        assert ws.media_bytes_by_device.get("host_dram_pcie", 0.0) <= peak / 8 + 1e-9


def test_arbiter_speculative_bytes_consume_bandwidth_budget():
    free = _drive_both()
    peak = max(ws.media_bytes_by_device.get("host_dram_pcie", 0) for ws in free.history)
    roomy = _drive_both(budget={"host_dram_pcie": peak * 1.01})
    assert all(ws.deferred_migrations == 0 for ws in roomy.history)
    spec = _drive_both(budget={"host_dram_pcie": peak * 1.01},
                       spec_bytes={"host_dram_pcie": peak * 0.9})
    assert any(ws.deferred_migrations > 0 for ws in spec.history)
    for ws in spec.history:
        assert ws.speculative_bytes_by_device == {"host_dram_pcie": peak * 0.9}


def test_simulator_replays_media_queues_and_prefetch_bills_bytes():
    def make(s):
        return s.gaussian_kv(n_regions=256, accesses_per_window=20_000, drift_frac=0.05)
    base = _simulate_both(make, "6T-AM-0.5", 256, windows=10)
    pre = _simulate_both(make, "6T-AM-0.5", 256, windows=10, prefetch=True)
    for ref, port in (base, pre):
        assert_same(ref, port)
    base, pre = base[1], pre[1]
    assert sum(base.media_bytes_by_device.values()) > 0
    assert all(v >= 0 for v in base.media_busy_s_by_device.values())
    assert base.prefetch_hits == 0 and base.prefetch_bytes == 0
    assert pre.prefetch_hits > 0 and pre.prefetch_bytes > 0
    assert pre.slowdown_pct < base.slowdown_pct
    np.testing.assert_array_equal(pre.placement_hists, base.placement_hists)
    np.testing.assert_array_equal(pre.fault_hists, base.fault_hists)
    assert pre.tco_savings_pct == base.tco_savings_pct
    assert sum(pre.media_bytes_by_device.values()) == pytest.approx(
        sum(base.media_bytes_by_device.values()) + pre.prefetch_bytes)


def test_simulate_multitenant_prefetch_reports_spec_bytes_to_arbiter():
    def run(pkg, prefetch):
        managers = [pkg.man.make_manager("6T-AM-0.5", 128, seed=t) for t in range(2)]
        arb = pkg.arb.BudgetArbiter([pkg.arb.TenantSpec("a", sla_weight=2.0),
                                     pkg.arb.TenantSpec("b")], managers, alpha=0.5)
        wls = [pkg.sim.gaussian_kv(n_regions=128, accesses_per_window=10_000, drift_frac=0.05)
               for _ in range(2)]
        return pkg.sim.simulate_multitenant(wls, arb, windows=8, prefetch=prefetch), arb

    with same_clock():
        (jr, jarb), (r, arb) = run(REF, True), run(PORT, True)
        (_, arb0) = run(PORT, False)
    assert_same(jr, r)
    assert_same(jarb.history, arb.history)
    assert r.prefetch_hits > 0 and r.prefetch_bytes > 0
    total = sum(b for ws in arb.history for b in ws.speculative_bytes_by_device.values())
    assert total == pytest.approx(r.prefetch_bytes)
    for ws, ws0 in zip(arb.history, arb0.history):
        for ts, ts0 in zip(ws.tenants, ws0.tenants):
            assert ts.fast_regions == ts0.fast_regions and ts.spent_usd == ts0.spent_usd


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------


def test_quickstart_prints_the_reference_lines():
    spec = importlib.util.spec_from_file_location("ref_quickstart",
                                                  ROOT / "examples" / "quickstart.py")
    ref_qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_qs)
    from repro_torch import quickstart

    outs = []
    with same_clock():
        for main in (ref_qs.main, quickstart.main):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main()
            outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    assert "6T-AM-0.5" in outs[1] and outs[1].count("\n") > 20
