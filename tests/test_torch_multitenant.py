"""Multi-tenancy in the port against the JAX package, on the CPU: the
arbiter's ``TenantLedger``, the ``BudgetArbiter``'s invariants, the serving
cache's tenant paths and the engine serving interleaved tenants.

The arbiter invariants of ``tests/test_multitenant.py`` (budgets summing to
the global budget, shared-capacity reconcile, SLA floors, determinism, the
hot tenant winning the fast tier, waterfall tenants) run on both packages:
the port must hold each invariant, and its per-window stats and placements
must equal the reference's exactly (the same numpy float64 on the same
streams). The cache's tenant paths (``tests/test_media.py``'s quota spills
and ``tests/test_multitenant.py``'s isolation tests) run on both caches in
lockstep: ``physical``, the device tables and the allocators' per-tenant use
are equal after every call. The engine serves the reference test's four
requests of two tenants in lockstep with the JAX engine; tokens, per-step
placements and the per-tenant stats are equal (TCO savings rel 1e-12).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import TierScapeRunConfig as JRunConfig  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core import arbiter as jarbiter  # noqa: E402
from repro.core import capacity as jcapacity  # noqa: E402
from repro.core import manager as jmanager  # noqa: E402
from repro.core import simulator as jsimulator  # noqa: E402
from repro.core.pools import TenantLedger as JLedger  # noqa: E402
from repro.frontend import admission as jadmission  # noqa: E402
from repro.frontend import scheduler as jscheduler  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving import kv_cache as jkvc  # noqa: E402
from repro.serving.engine import TieredEngine as JEngine  # noqa: E402
from repro_torch.configs import TierScapeRunConfig, get_smoke as port_smoke  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import arbiter, capacity, manager, simulator  # noqa: E402
from repro_torch.core.pools import TenantLedger  # noqa: E402
from repro_torch.frontend import admission, scheduler  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import kv_cache as kvc  # noqa: E402
from repro_torch.serving.engine import TieredEngine  # noqa: E402

WARM, COLD, HOST8, HOST4 = kvc.WARM, kvc.COLD, kvc.HOST8, kvc.HOST4
assert (WARM, COLD, HOST8, HOST4) == (jkvc.WARM, jkvc.COLD, jkvc.HOST8, jkvc.HOST4)


def assert_same(a, b, path="value"):
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
        assert type(a) is type(b) and a == b, (path, a, b)


# ---------------------------------------------------------------------------
# TenantLedger
# ---------------------------------------------------------------------------


def _ledger_trace(cls, seed):
    rng = np.random.default_rng(seed)
    ledger = cls(["a", "b", "c"], np.array([6.0, 10.0, np.inf]))
    out = []
    for _ in range(80):
        op, t, k = int(rng.integers(0, 4)), "abc"[int(rng.integers(0, 3))], int(rng.integers(0, 3))
        n = int(rng.integers(0, 4))
        if op == 0:
            ledger.set_usage(t, rng.integers(0, 4, 3))
            out.append(None)
        elif op == 1:
            out.append(ledger.reserve(t, k, n))
        elif op == 2:
            ledger.release(t, k, n)
            out.append(None)
        else:
            out.append(ledger.headroom(k))
        out.append((ledger.usage.copy(), ledger.reserved.copy(), ledger.oversubscribed(),
                    ledger.tenant_usage(t), ledger.index(t)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_tenant_ledger_matches_reference(seed):
    port, ref = _ledger_trace(TenantLedger, seed), _ledger_trace(JLedger, seed)
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        if isinstance(p, tuple):
            for x, y in zip(p, r):
                np.testing.assert_array_equal(x, y, err_msg=f"op {i}")
        else:
            assert p == r, i


def test_tenant_ledger_reservations_and_errors():
    for cls in (TenantLedger, JLedger):
        ledger = cls(["a", "b"], np.array([4.0, 8.0]))
        ledger.set_usage("a", np.array([2, 3]))
        ledger.set_usage("b", np.array([1, 2]))
        assert ledger.headroom(0) == 1
        assert ledger.reserve("a", 0, 1)
        assert not ledger.reserve("b", 0, 1)
        ledger.release("a", 0, 1)
        assert ledger.reserve("b", 0, 1)
        assert not ledger.oversubscribed().any()
        ledger.set_usage("b", np.array([4, 2]))
        assert ledger.oversubscribed()[0]
        with pytest.raises(ValueError):
            ledger.set_usage("a", np.array([1, 2, 3]))
        with pytest.raises(ValueError):
            cls(["a", "a"], np.array([1.0]))


# ---------------------------------------------------------------------------
# BudgetArbiter invariants, on both packages
# ---------------------------------------------------------------------------

N, ACC = 256, 50_000
PORT = (simulator, arbiter, manager)
REF = (jsimulator, jarbiter, jmanager)


def hot_cold(sim, n=N):
    return [sim.gaussian_kv(n_regions=n, accesses_per_window=ACC, sigma_frac=0.08, name="hot"),
            sim.uniform_scan(n_regions=n, accesses_per_window=ACC // 10,
                             compute_s_per_window=1.0, name="cold")]


def twin_gauss(sim, n=N):
    return [sim.gaussian_kv(n_regions=n, accesses_per_window=ACC, sigma_frac=0.1, name=nm)
            for nm in ("w1", "w2")]


def two_tenant_arbiter(pkg, weights=(1.0, 1.0), floors=(0.0, 0.0), caps=None,
                       config="6T-AM-0.5", n=N, alpha=0.5):
    _, arb_mod, man_mod = pkg
    specs = [arb_mod.TenantSpec("a", sla_weight=weights[0], alpha_floor=floors[0]),
             arb_mod.TenantSpec("b", sla_weight=weights[1], alpha_floor=floors[1])]
    managers = [man_mod.make_manager(config, n, seed=t) for t in range(2)]
    return arb_mod.BudgetArbiter(specs, managers, alpha=alpha, tier_capacity_regions=caps)


def run_both(workloads, windows=6, seed=0, **arb_kw):
    """The same arbiter and traces on both packages; the port's per-window
    stats, final placements and ledger must equal the reference's. Returns
    the port's (arbiter, result)."""
    out = []
    for pkg in (REF, PORT):
        arb = two_tenant_arbiter(pkg, **arb_kw)
        res = pkg[0].simulate_multitenant(workloads(pkg[0]), arb, windows=windows, seed=seed)
        out.append((arb, res))
    (jarb, jres), (arb, res) = out
    assert len(arb.history) == windows
    assert_same(jres, res)
    assert_same(jarb.history, arb.history)
    for jm, m in zip(jarb.managers, arb.managers):
        np.testing.assert_array_equal(m.placement, jm.placement)
    np.testing.assert_array_equal(arb.ledger.usage, jarb.ledger.usage)
    return arb, res


def test_budgets_sum_to_global_budget():
    arb, _ = run_both(hot_cold)
    for ws in arb.history:
        assert ws.budget_feasible
        assert sum(ts.budget_usd for ts in ws.tenants) == pytest.approx(ws.global_budget_usd,
                                                                        rel=1e-9)
        for ts in ws.tenants:
            assert ts.spent_usd <= ts.budget_usd * (1 + 1e-9)


def test_ledger_tracks_usage_within_capacity():
    caps = np.full(6, 2.0 * N)
    caps[0] = N
    arb, _ = run_both(hot_cold, caps=caps)
    for name, m in zip(("a", "b"), arb.managers):
        assert arb.ledger.tenant_usage(name).sum() == m.n_regions
    assert not arb.ledger.oversubscribed().any()
    assert (arb.ledger.usage.sum(axis=0) <= caps).all()


def test_capacity_reconcile_enforces_fast_tier_cap():
    caps = np.full(6, np.inf)
    caps[0] = N // 4
    arb, _ = run_both(hot_cold, caps=caps, alpha=0.9)
    for ws in arb.history:
        assert sum(ts.fast_regions for ts in ws.tenants) <= N // 4


def test_capacity_reconcile_prefers_above_floor_victims():
    caps = np.full(6, np.inf)
    caps[0] = N // 3
    arb, res = run_both(twin_gauss, floors=(0.0, 0.6), caps=caps, alpha=0.9)
    unfloored, floored = res.tenants
    for ws in arb.history:
        assert sum(ts.fast_regions for ts in ws.tenants) <= N // 3
        assert ws.tenants[1].spent_usd > ws.tenants[0].spent_usd
    assert floored.mean_fast_regions > unfloored.mean_fast_regions


def test_capacity_overflow_spills_upward_when_deep_tiers_full():
    caps = np.array([2.0 * N, N / 2])

    def idle(sim):
        return [sim.Workload("idle%d" % t, N, 10, 1.0, lambda w, rng: np.zeros(N))
                for t in range(2)]
    arb, _ = run_both(idle, windows=4, config="2T-M", caps=caps)
    assert (arb.ledger.usage.sum(axis=0) <= caps).all()
    assert not arb.ledger.oversubscribed().any()


def test_arbiter_rejects_infeasible_capacity():
    for pkg in (PORT, REF):
        with pytest.raises(ValueError):
            two_tenant_arbiter(pkg, caps=np.full(6, 10.0))


def test_arbiter_deterministic_under_fixed_seed():
    a, _ = run_both(hot_cold, windows=5, seed=3)
    b, _ = run_both(hot_cold, windows=5, seed=3)
    assert_same(a.history, b.history)
    for ma, mb in zip(a.managers, b.managers):
        np.testing.assert_array_equal(ma.placement, mb.placement)


def test_starved_tenant_meets_sla_floor():
    def wls(sim):
        return [sim.gaussian_kv(n_regions=N, accesses_per_window=ACC * 4, sigma_frac=0.05,
                                name="noisy"),
                sim.uniform_scan(n_regions=N, accesses_per_window=ACC // 50,
                                 compute_s_per_window=1.0, name="starved")]
    arb, _ = run_both(wls, floors=(0.0, 0.4), alpha=0.1)
    floorless, _ = run_both(wls, floors=(0.0, 0.0), alpha=0.1)
    bound = 0
    for ws, ws0 in zip(arb.history, floorless.history):
        starved = ws.tenants[1]
        assert starved.budget_usd >= starved.sla_floor_usd * (1 - 1e-9)
        bound += ws0.tenants[1].budget_usd < starved.sla_floor_usd
    assert bound > 0, "scenario never exercised the SLA floor"


def test_sla_weight_shifts_fast_tier():
    _, res = run_both(twin_gauss, windows=8, weights=(4.0, 1.0))
    heavy, light = res.tenants
    assert heavy.mean_fast_regions >= light.mean_fast_regions
    assert heavy.mean_budget_usd > light.mean_budget_usd


def test_hot_tenant_wins_fast_tier_and_aggregate_within_5pct():
    _, res = run_both(hot_cold, windows=10)
    hot, cold = res.tenants
    assert hot.mean_fast_regions > cold.mean_fast_regions + N // 10
    baselines = [sim.simulate_single_tenant_baseline(hot_cold(sim), man.make_manager(
        "6T-AM-0.5", 2 * N, seed=0), windows=10, warmup_windows=2, seed=0)
        for sim, _, man in (REF, PORT)]
    assert baselines[1] == baselines[0]
    assert abs(res.fleet_savings_pct - baselines[1]) <= 5.0


def test_waterfall_tenants_share_arbiter():
    caps = np.full(2, np.inf)
    caps[0] = N // 2
    arb, res = run_both(hot_cold, config="2T-M", caps=caps)
    for ws in arb.history:
        assert sum(ts.fast_regions for ts in ws.tenants) <= N // 2
    assert res.windows == 6


# ---------------------------------------------------------------------------
# the serving cache's tenant paths, both caches in lockstep
# ---------------------------------------------------------------------------

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=128, head_dim=16)
KV, HD = TINY["n_kv_heads"], TINY["head_dim"]


class Pair:
    """A reference cache and a port cache driven with the same calls; every
    call is followed by a comparison of placements, tables and per-tenant
    allocator use."""

    def __init__(self, slots=2, warm_frac=0.5, tenant_quota=None):
        kw = dict(warm_frac=warm_frac, tenant_quota=tenant_quota)
        self.j = jkvc.TieredKVCache(JModelConfig(**TINY), 2, slots, 8, 64, 16,
                                    jmanager.ManagerConfig(policy="analytical", alpha=0.5), **kw)
        self.t = kvc.TieredKVCache(ModelConfig(**TINY), 2, slots, 8, 64, 16,
                                   manager.ManagerConfig(policy="analytical", alpha=0.5),
                                   device="cpu", **kw)
        self.tenants = set()

    def set_slot_tenant(self, slot, tenant):
        self.tenants.add(tenant)
        for c in (self.j, self.t):
            c.set_slot_tenant(slot, tenant)
        self.check()

    def append_pages(self, entries, k, v):
        self.j.append_pages(entries, jnp.asarray(k), jnp.asarray(v))
        self.t.append_pages(entries, torch.from_numpy(k), torch.from_numpy(v))
        self.check()

    def fill(self, rng, n_pages):
        coords = [(la, sl, pg) for la in range(self.t.la) for sl in range(self.t.bs)
                  for pg in range(self.t.max_pages)][:n_pages]
        k = rng.normal(0, 1, (len(coords), 8, KV, HD)).astype(np.float32)
        v = rng.normal(0, 1, (len(coords), 8, KV, HD)).astype(np.float32)
        self.append_pages(coords, k, v)

    def migrate_batch(self, rids, dsts):
        moved = self.t.migrate_batch(rids, dsts)
        assert moved == self.j.migrate_batch(rids, dsts)
        self.check()
        return moved

    def check(self):
        j, t = self.j, self.t
        np.testing.assert_array_equal(t.physical, j.physical)
        np.testing.assert_array_equal(t._page_exists, j._page_exists)
        np.testing.assert_array_equal(t.manager.placement, j.manager.placement)
        np.testing.assert_array_equal(t.slot_tenant, j.slot_tenant)
        for f in ("warm_table", "warm_n", "cold_table", "cold_n", "host_table", "host_n"):
            np.testing.assert_array_equal(getattr(t.state, f).numpy(),
                                          np.asarray(getattr(j.state, f)), err_msg=f)
        for pool in ("warm", "cold"):
            for tenant in self.tenants:
                assert t._alloc[pool].used_by(tenant) == j._alloc[pool].used_by(tenant), pool
            assert t._alloc[pool].used == j._alloc[pool].used, pool
        assert set(t.host_pages) == set(j.host_pages)
        check_table_invariants(t)

    def count(self, level, tenant):
        t = self.t
        return int(((t.physical == level) & t._page_exists & t.tenant_mask(tenant)).sum())


def check_table_invariants(cache):
    """Every pooled page appears exactly once in its (layer, slot) row; rows
    hold nothing else; free lists are disjoint from live slots
    (``tests/test_migration.py``)."""
    for pool, level in (("warm", WARM), ("cold", COLD)):
        table = getattr(cache.state, f"{pool}_table").numpy()
        nvec = getattr(cache.state, f"{pool}_n").numpy()
        want = {}
        live = np.where((cache.physical == level) & cache._page_exists)[0]
        for rid in live:
            layer, slot, _ = cache.rid_coords(int(rid))
            want.setdefault((layer, slot), []).append(int(cache._pool_slot[rid]))
        for layer in range(cache.la):
            for slot in range(cache.bs):
                row = sorted(table[layer, slot, :int(nvec[layer, slot])].tolist())
                assert row == sorted(want.get((layer, slot), [])), (pool, layer, slot)
        free = cache._free_warm if level == WARM else cache._free_cold
        assert not (set(free) & {int(cache._pool_slot[r]) for r in live}), pool


def test_tenant_quota_caps_warm_residency_on_append():
    p = Pair(warm_frac=0.25, tenant_quota={"warm": {0: 3, 1: 5}})
    assert p.t._alloc["warm"].capacity == 8
    p.set_slot_tenant(0, 0)
    p.set_slot_tenant(1, 1)
    rng = np.random.default_rng(0)
    entries = [(la, 0, pg) for la in range(2) for pg in range(6)]
    k = rng.normal(0, 1, (len(entries), 8, KV, HD)).astype(np.float32)
    p.append_pages(entries, k, k * 0.3)
    assert p.count(WARM, 0) == 3 and p.t._alloc["warm"].used_by(0) == 3
    entries1 = [(la, 1, pg) for la in range(2) for pg in range(2)]
    k1 = rng.normal(0, 1, (len(entries1), 8, KV, HD)).astype(np.float32)
    p.append_pages(entries1, k1, k1 * 0.3)
    assert p.count(WARM, 1) == 4


def test_tenant_quota_bounds_promotions_in_migrate_batch():
    p = Pair(warm_frac=0.5, tenant_quota={"warm": {0: 2, 1: 14}})
    p.set_slot_tenant(0, 0)
    p.set_slot_tenant(1, 1)
    p.fill(np.random.default_rng(2), 20)
    live = np.where(p.t._page_exists)[0]
    p.migrate_batch(live, np.full(live.size, COLD, np.int64))
    mine = np.where(p.t._page_exists & p.t.tenant_mask(0))[0]
    p.migrate_batch(mine, np.full(mine.size, WARM, np.int64))
    assert p.count(WARM, 0) <= 2 and p.count(COLD, 0) > 0
    assert p.t._alloc["warm"].used_by(0) == p.count(WARM, 0)


def test_cold_quota_batch_demotion_spills_to_host():
    p = Pair(warm_frac=1.0, tenant_quota={"cold": {0: 2, 1: 30}})
    p.set_slot_tenant(0, 0)
    p.set_slot_tenant(1, 0)
    p.fill(np.random.default_rng(6), 16)
    live = np.where(p.t._page_exists)[0]
    assert p.migrate_batch(live, np.full(live.size, COLD, np.int64)) == live.size
    assert p.count(COLD, 0) == 2
    assert p.count(HOST4, 0) == live.size - 2
    assert p.t._alloc["cold"].used_by(0) == 2


def test_quota_requires_known_tenant():
    p = Pair(tenant_quota={"warm": {1: 4}})
    p.set_slot_tenant(0, 0)
    with pytest.raises(KeyError):
        p.t.append_page(0, 0, 0, torch.zeros(8, KV, HD), torch.zeros(8, KV, HD))
    with pytest.raises(KeyError):
        p.j.append_page(0, 0, 0, jnp.zeros((8, KV, HD)), jnp.zeros((8, KV, HD)))


def test_tenant_masks_partition_cache_pages():
    p = Pair(slots=4)
    for slot, tenant in enumerate((0, 0, 1, 1)):
        p.set_slot_tenant(slot, tenant)
    p.fill(np.random.default_rng(0), 24)
    c = p.t
    m0, m1 = c.tenant_mask(0), c.tenant_mask(1)
    np.testing.assert_array_equal(m0, p.j.tenant_mask(0))
    assert not (m0 & m1).any() and (m0 | m1).all()
    assert c.tco_usd() == pytest.approx(c.tco_usd(0) + c.tco_usd(1), rel=1e-12)
    for tenant in (None, 0, 1):
        assert c.tco_usd(tenant) == pytest.approx(p.j.tco_usd(tenant), rel=1e-12)
        assert c.tco_savings_pct(tenant) == pytest.approx(p.j.tco_savings_pct(tenant),
                                                          rel=1e-12)


def test_no_cross_tenant_page_reads():
    """Every row (layer, slot) of the device tables, the decode kernel's read
    path, references only pool rows holding that slot's own pages."""
    p = Pair(slots=4)
    for slot, tenant in enumerate((0, 1, 0, 1)):
        p.set_slot_tenant(slot, tenant)
    rng = np.random.default_rng(1)
    p.fill(rng, 32)
    live = np.where(p.t._page_exists)[0]
    dsts = np.array([rng.choice([WARM, COLD, HOST8, HOST4]) for _ in live])
    p.migrate_batch(live, dsts)
    c = p.t
    for pool, level in (("warm", WARM), ("cold", COLD)):
        table = getattr(c.state, f"{pool}_table").numpy()
        nvec = getattr(c.state, f"{pool}_n").numpy()
        owner = {}
        for rid in np.where((c.physical == level) & c._page_exists)[0]:
            layer, slot, _ = c.rid_coords(int(rid))
            owner[(layer, int(c._pool_slot[rid]))] = slot
        for layer in range(c.la):
            for slot in range(c.bs):
                for j in range(int(nvec[layer, slot])):
                    assert owner[(layer, int(table[layer, slot, j]))] == slot
    assert all(c._page_exists[rid] for rid in c.host_pages)


def _staged(p, rng):
    """Stage one cohort of a device pool and one of a host tier in both caches
    and commit neither: those pages are in flight (out of every table)."""
    for levels in ((WARM, COLD), (HOST8, HOST4)):
        for src in levels:
            rids = np.where(p.t.physical == src)[0]
            if rids.size:
                rids = rng.choice(rids, max(rids.size // 2, 1), replace=False)
                dst = HOST4 if src in (WARM, COLD) else WARM
                for c in (p.j, p.t):
                    c.stage_cohort(np.sort(rids), src, dst)
                break
    assert (p.t.physical == kvc.INFLIGHT).any()
    np.testing.assert_array_equal(p.t.physical, p.j.physical)
    p.check()


FOLD_CASES = ([(s, "placed") for s in range(5)] + [(s, "in_flight") for s in range(3)]
              + [(s, "host_mass") for s in range(3)])


@pytest.mark.parametrize("seed,case", FOLD_CASES,
                         ids=[str(s) if c == "placed" else f"{c}-{s}" for s, c in FOLD_CASES])
def test_fold_telemetry_matches_reference_loop(seed, case):
    """The port's fold from its host tables equals the reference's fold and
    its per-entry loop on the same telemetry: pages placed, pages in flight
    (staged, not committed), and the host sentinels' masses."""
    rng = np.random.default_rng(seed)
    p = Pair(slots=4)
    p.fill(rng, int(rng.integers(4, p.t.n_regions + 1)))
    live = np.where(p.t._page_exists)[0]
    p.migrate_batch(live, np.array([rng.choice([WARM, COLD, HOST8, HOST4]) for _ in live]))
    if case == "in_flight":
        _staged(p, rng)
    # f32 masses, as the decode step emits them
    telemetry = {pool: rng.random(tuple(getattr(p.t.state, f"{pool}_table").shape),
                                  dtype=np.float32) for pool in ("warm", "cold", "host")}
    jtel = {k: jnp.asarray(v) for k, v in telemetry.items()}
    if case == "host_mass":
        got = p.t._fold_host_mass(telemetry["host"])
        assert got.sum() > 0
        np.testing.assert_array_equal(got, p.j._fold_host_mass(jtel["host"]))
        return
    got = p.t._fold_telemetry(telemetry)
    np.testing.assert_array_equal(got, p.j._fold_telemetry(jtel))
    np.testing.assert_allclose(got, p.j._fold_telemetry_loop(jtel), rtol=1e-12)


def test_fold_reads_no_device_table():
    """Device tables overwritten with garbage after the last commit: the
    fold still gives the reference's counts and host masses on the unspoiled
    state, and uploads nothing."""
    rng = np.random.default_rng(7)
    p = Pair(slots=4)
    p.fill(rng, 40)
    live = np.where(p.t._page_exists)[0]
    p.migrate_batch(live, np.array([rng.choice([WARM, COLD, HOST8, HOST4]) for _ in live]))
    telemetry = {pool: rng.random(tuple(getattr(p.t.state, f"{pool}_table").shape),
                                  dtype=np.float32) for pool in ("warm", "cold", "host")}

    def uploads():
        return sum(r[4] for r in p.t.tracer.records(0, 1) if r[0] == "cache.table_uploads")

    before = uploads()
    assert before > 0
    st = p.t.state
    for pool in ("warm", "cold", "host"):
        getattr(st, f"{pool}_table").random_(0, 1 << 20)
        getattr(st, f"{pool}_n").fill_(st.warm_table.shape[2])
    p.t.record_telemetry(telemetry)
    p.j.record_telemetry({k: jnp.asarray(v) for k, v in telemetry.items()})
    assert p.t.manager.telemetry._accum.sum() > 0 and p.t.manager.host_mass.sum() > 0
    np.testing.assert_array_equal(p.t.manager.telemetry._accum, p.j.manager.telemetry._accum)
    np.testing.assert_array_equal(p.t.manager.host_mass, p.j.manager.host_mass)
    assert uploads() == before


def test_record_telemetry_feeds_manager():
    p = Pair()
    p.fill(np.random.default_rng(2), 16)
    telemetry = {pool: np.random.default_rng(3).random(
        tuple(getattr(p.t.state, f"{pool}_table").shape), dtype=np.float32)
        for pool in ("warm", "cold")}
    p.t.record_telemetry(telemetry)
    p.j.record_telemetry({k: jnp.asarray(v) for k, v in telemetry.items()})
    assert p.t.manager.telemetry._accum.sum() > 0
    np.testing.assert_array_equal(p.t.manager.telemetry._accum, p.j.manager.telemetry._accum)


# ---------------------------------------------------------------------------
# the engine: one engine, interleaved tenant traffic
# ---------------------------------------------------------------------------

ENGINE = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
RUN = dict(enabled=True, policy="analytical", alpha=0.3, window_steps=6)


def test_engine_serves_interleaved_tenants_like_reference():
    """``tests/test_multitenant.py::test_engine_serves_interleaved_tenants``
    on both engines in lockstep (its settings: the default async + prefetch
    path, ``PRNGKey(0)``, prompts from ``default_rng(0)``)."""
    cfg = get_smoke("qwen1_5_4b")
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(port_smoke("qwen1_5_4b"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    je = JEngine(jm, jp, ts=JRunConfig(**RUN), **ENGINE)
    te = TieredEngine(tm, tp, ts=TierScapeRunConfig(**RUN), device="cpu", **ENGINE)
    rng = np.random.default_rng(0)
    jreqs, treqs = [], []
    for tenant in (0, 1, 0, 1):
        prompt = rng.integers(1, cfg.vocab_size, 24)
        jreqs.append(je.submit(prompt, max_new_tokens=10, tenant=tenant))
        treqs.append(te.submit(prompt, max_new_tokens=10, tenant=tenant))
    both_live = False
    while (any(s is not None for s in je.slots) or je.queue) and je.stats.steps < 80:
        je._fill_slots()
        te._fill_slots()
        both_live |= {r.tenant for r in te.slots if r is not None} == {0, 1}
        je.step()
        te.step()
        step = je.stats.steps
        np.testing.assert_array_equal(te.cache.physical, je.cache.physical, err_msg=f"{step}")
        np.testing.assert_array_equal(te.cache.manager.placement, je.cache.manager.placement,
                                      err_msg=f"step {step}")
        np.testing.assert_array_equal(te.cache.slot_tenant, je.cache.slot_tenant)
    js, ts = je.finish(), te.finish()
    assert both_live
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == 10 and r.done for r in treqs)
    assert ts.completed == js.completed == 4
    assert ts.completed_by_tenant == js.completed_by_tenant == {0: 2, 1: 2}
    assert set(ts.tco_savings_by_tenant) == set(js.tco_savings_by_tenant) == {0, 1}
    for t, v in js.tco_savings_by_tenant.items():
        assert ts.tco_savings_by_tenant[t] == pytest.approx(v, rel=1e-12)
    for f in ("steps", "windows", "migrations", "overlapped_steps", "prefetch_staged",
              "prefetch_hits", "prefetch_misses"):
        assert getattr(ts, f) == getattr(js, f), f
    assert te.cache.pipeline.prefetch_hit_rate() == je.cache.pipeline.prefetch_hit_rate()
    assert te.cache.pipeline.media_bytes() == je.cache.pipeline.media_bytes()
    for name, busy in je.cache.pipeline.media_busy_s().items():
        assert te.cache.pipeline.media_busy_s()[name] == pytest.approx(busy, rel=1e-12)


# ---------------------------------------------------------------------------
# scheduled demand -> arbiter -> fleet report -> planner
# ---------------------------------------------------------------------------


def _demand_chain(sim, cap_mod, arb_mod, stats):
    def workloads():
        return [sim.skew_flip(n_regions=128, accesses_hot=50_000, accesses_cold=5_000,
                              flip_window=4, hot_first=first, name=nm)
                for first, nm in ((True, "early"), (False, "late"))]
    specs = [arb_mod.TenantSpec("early", sla_weight=1.0),
             arb_mod.TenantSpec("late", sla_weight=1.0)]
    cfg = cap_mod.PlannerConfig("6t", alpha=0.5, fast_fraction=0.5)
    arb = cap_mod.build_arbiter(cfg, specs, 128)
    sim.simulate_multitenant(workloads(), arb, windows=8, warmup_windows=2, seed=7,
                             prefetch=False)
    synthetic = arb.fleet_report(last_windows=6).tenant_demand_accesses
    stats.demand_windows = [{0: 120.0, 1: 30.0}, {0: 80.0, 1: 50.0}, {0: 100.0}]
    fed = stats.feed_arbiter(arb, ("early", "late"))
    report = arb.fleet_report(last_windows=6)
    planner = cap_mod.CapacityPlanner(cap_mod.get_server("v5e-base"), fleet_scale=64)
    return arb, fed, synthetic, report, planner.evaluate(cfg.name, report)


def test_scheduled_demand_flows_to_fleet_report_and_planner():
    """``tests/test_frontend.py::test_scheduled_demand_flows_to_fleet_report_and_planner``
    with the port's ``FrontendStats`` feeding the port's arbiter."""
    port = _demand_chain(simulator, capacity, arbiter, scheduler.FrontendStats(
        records=[], classes=admission.DEFAULT_CLASSES))
    ref = _demand_chain(jsimulator, jcapacity, jarbiter, jscheduler.FrontendStats(
        records=[], classes=jadmission.DEFAULT_CLASSES))
    arb, fed, synthetic, report, point = port
    assert fed == ref[1] == 3
    assert report.tenant_demand_accesses == (100.0, 80.0 / 3)
    assert report.tenant_demand_accesses != synthetic
    assert synthetic == ref[2]
    assert_same(ref[3], report)
    assert point.to_dict() == ref[4].to_dict()
    assert point.servers >= 1 and 0.0 <= point.savings_pct <= 100.0
    with pytest.raises(KeyError):
        arb.record_scheduled_demand({"nobody": 1.0})
