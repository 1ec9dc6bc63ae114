"""The port's serving frontend (``repro_torch.frontend``) against the JAX
package's, on the CPU.

Traces, admission and the router are pure Python and numpy in both
packages: the same config gives the same events and ``digest`` for every
trace kind at seeds 0-3, the same prompt token ids, and the same admission
decisions and route sequences on grids of loads. The reference's own trace,
admission and router tests (``tests/test_frontend.py``,
``tests/test_faults.py``) run on the port's modules.

The scheduler runs in lockstep: the port's ``ContinuousScheduler`` over two
port engines against the reference's over two JAX engines, on the
``qwen1_5_4b`` SMOKE (weights carried across) and the burst trace of
``tests/test_frontend.py::test_scheduler_burst_preempts_and_resumes``, once
plain and once with replica 0 hard-failing at step 20. Per-record state,
token steps, first-token and done steps, preemptions, replica, out tokens,
``summary()``, ``demand_windows`` and each engine's final placements are
compared exactly. The parameter key was checked to keep greedy decoding
clear of bf16 ties (at ``PRNGKey(0)`` one record meets a one-ulp tie,
ROADMAP §3); the trace is the reference test's, unshortened.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import frontend as jfe  # noqa: E402
from repro.frontend import traces as jtraces  # noqa: E402
from repro_torch import frontend as tfe  # noqa: E402
from repro_torch.frontend import traces as ttraces  # noqa: E402

KINDS = ("poisson", "diurnal", "burst")


def _trace_kw(kind, seed):
    return dict(kind=kind, seed=seed, steps=96, rate=0.5, tenant_mix=(0.8, 0.2),
                tenant_flip_step=48, burst_sla=1, n_sessions=5, sla_mix=(0.6, 0.4))


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_trace_digest_and_prompts_equal_reference(kind, seed):
    kw = _trace_kw(kind, seed)
    j, t = jfe.generate(jfe.TraceConfig(**kw)), tfe.generate(tfe.TraceConfig(**kw))
    assert len(t) == len(j) > 0
    assert tfe.digest(t) == jfe.digest(j)
    assert [e.key() for e in t] == [e.key() for e in j]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.prompt(256), b.prompt(256))
        assert a.prompt(256).dtype == np.int32
    for step in range(0, 96, 7):
        assert ttraces.rate_at(tfe.TraceConfig(**kw), step) == jtraces.rate_at(
            jfe.TraceConfig(**kw), step)


def test_trace_check_and_cli(capsys):
    assert ttraces.check(seeds=(0, 5)) == 0
    assert ttraces.main(["--check"]) == 0
    assert "PASS" in capsys.readouterr().out
    assert ttraces.main(["--kind", "burst", "--steps", "32"]) == 0
    with pytest.raises(ValueError, match="unknown trace kind"):
        tfe.generate(tfe.TraceConfig(kind="bogus"))
    with pytest.raises(ValueError, match="tenant_mix"):
        tfe.generate(tfe.TraceConfig(tenant_mix=(1.0,)))


def test_trace_burst_pins_sla_and_raises_rate():
    ev = tfe.generate(tfe.TraceConfig(kind="burst", steps=96, rate=0.2, seed=1, burst_every=32,
                                      burst_len=8, burst_mult=10.0, burst_sla=1))
    in_burst = [e for e in ev if (e.step % 32) < 8]
    out_burst = [e for e in ev if (e.step % 32) >= 8]
    assert len(in_burst) > len(out_burst)
    assert all(e.sla == 1 for e in in_burst)


def test_trace_tenant_skew_flip():
    ev = tfe.generate(tfe.TraceConfig(kind="poisson", steps=200, rate=1.0, seed=2,
                                      tenant_mix=(0.9, 0.1), tenant_flip_step=100))
    early = [e.tenant for e in ev if e.step < 100]
    late = [e.tenant for e in ev if e.step >= 100]
    assert np.mean(early) < 0.3 and np.mean(late) > 0.7


# ---------------------------------------------------------------------------
# Admission and the router
# ---------------------------------------------------------------------------


def _event(mod, sla=0, session=0, prompt=16, gen=8, seq=0):
    return mod.ArrivalEvent(step=0, seq=seq, tenant=0, sla=sla, session=session,
                            prompt_len=prompt, max_new_tokens=gen, prompt_seed=1)


def test_admission_decisions_equal_reference_on_a_grid():
    jc, tc = jfe.AdmissionController(jfe.DEFAULT_CLASSES), tfe.AdmissionController()
    assert [c.name for c in tc.classes] == ["batch", "interactive"]
    assert tfe.DEFAULT_CLASSES == tuple(tfe.SLAClass(**vars(c)) for c in jfe.DEFAULT_CLASSES)
    n = 0
    for sla in (0, 1):
        for prompt, gen in ((16, 8), (200, 40)):
            for out in (0, 300, 700, 740, 760, 990, 1200):
                for head in (0, 3, 24, 1000):
                    for free in (False, True):
                        for queued in (0, 15, 16, 255, 256):
                            kw = dict(capacity_tokens=1000, outstanding_tokens=out,
                                      headroom_tokens=head, free_slot=free,
                                      queued_of_class=queued)
                            want = jc.decide(_event(jfe, sla, prompt=prompt, gen=gen), **kw)
                            got = tc.decide(_event(tfe, sla, prompt=prompt, gen=gen), **kw)
                            assert got == want, (sla, prompt, gen, kw)
                            n += 1
    assert n == 2 * 2 * 7 * 4 * 2 * 5
    # The reference test's cases, on the port.
    kw = dict(capacity_tokens=1000, outstanding_tokens=0, headroom_tokens=1000,
              free_slot=True, queued_of_class=0)
    assert tc.decide(_event(tfe, 0), **kw) == tfe.ADMIT
    assert tc.decide(_event(tfe, 0), **{**kw, "outstanding_tokens": 740}) == tfe.REFUSE
    assert tc.decide(_event(tfe, 1), **{**kw, "outstanding_tokens": 740}) == tfe.ADMIT
    assert tc.decide(_event(tfe, 1), **{**kw, "queued_of_class": 16}) == tfe.REFUSE
    assert tc.decide(_event(tfe, 0), **{**kw, "free_slot": False}) == tfe.QUEUE
    assert tc.decide(_event(tfe, 0), **{**kw, "headroom_tokens": 3}) == tfe.QUEUE
    with pytest.raises(ValueError):
        tfe.AdmissionController(())


def test_router_route_sequences_equal_reference():
    """A seeded sequence of routes, completions and health changes drives
    both routers; every pick and every refusal is the same."""
    rng = np.random.default_rng(0)
    jr, tr = jfe.ReplicaRouter(3), tfe.ReplicaRouter(3)
    live = []
    for i in range(400):
        op = rng.integers(10)
        if op < 6:
            s = int(rng.integers(6))
            out = [int(x) for x in rng.integers(0, 100, 3)]
            a = jr.route(_event(jfe, session=s, seq=i), out)
            b = tr.route(_event(tfe, session=s, seq=i), out)
            assert a == b, i
            assert b not in tr.dead
            live.append(s)
        elif op < 8 and live:
            s = live.pop(int(rng.integers(len(live))))
            jr.note_done(_event(jfe, session=s))
            tr.note_done(_event(tfe, session=s))
        elif op == 8:
            r = int(rng.integers(3))
            outcome = []
            for router in (jr, tr):
                try:
                    router.mark_down(r)
                    outcome.append("down")
                except RuntimeError:
                    outcome.append("refused")
            assert outcome[0] == outcome[1]
        else:
            r = int(rng.integers(3))
            jr.mark_up(r)
            tr.mark_up(r)
        assert tr.dead == jr.dead


def test_router_least_outstanding_with_session_affinity():
    r = tfe.ReplicaRouter(3)
    assert r.route(_event(tfe, session=7), [100, 40, 60]) == 1
    assert r.route(_event(tfe, session=7), [100, 90, 10]) == 1
    assert r.route(_event(tfe, session=8), [50, 90, 50]) == 0
    r.note_done(_event(tfe, session=7))
    r.note_done(_event(tfe, session=7))
    assert r.route(_event(tfe, session=7), [100, 90, 10]) == 2


def _ev(session):
    return tfe.ArrivalEvent(step=0, seq=session, tenant=0, sla=0, session=session,
                            prompt_len=8, max_new_tokens=4, prompt_seed=0)


def test_router_skips_dead_replicas_and_rebinds_affinity():
    r = tfe.ReplicaRouter(3)
    assert r.route(_ev(7), [5, 0, 9]) == 1
    assert r.route(_ev(7), [5, 0, 9]) == 1
    r.mark_down(1)
    assert r.route(_ev(7), [5, 0, 9]) == 0
    assert r.route(_ev(8), [5, 0, 9]) == 0
    r.mark_up(1)
    assert r.route(_ev(9), [5, 0, 9]) == 1


def test_router_refuses_to_kill_the_last_live_replica():
    r = tfe.ReplicaRouter(2)
    r.mark_down(0)
    with pytest.raises(RuntimeError):
        r.mark_down(1)
    assert r.dead == frozenset({0})
    assert r.route(_ev(1), [3, 3]) == 1
    with pytest.raises(ValueError):
        r.mark_down(5)
    with pytest.raises(ValueError):
        tfe.ReplicaRouter(0)


# ---------------------------------------------------------------------------
# The scheduler in lockstep
# ---------------------------------------------------------------------------

PARAM_KEY = 4
GEOM = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
# tests/test_frontend.py::test_scheduler_burst_preempts_and_resumes
BURST = dict(kind="burst", steps=60, rate=0.10, seed=3, sla_mix=(0.85, 0.15), burst_every=24,
             burst_len=4, burst_mult=8.0, burst_sla=1, prompt_len=(10, 18), new_tokens=(8, 14),
             n_tenants=2, tenant_mix=(0.8, 0.2), tenant_flip_step=30)
CHUNK = 8


@pytest.fixture(scope="module")
def models():
    from repro.configs import get_smoke
    from repro.models import Model as JModel
    from repro_torch.configs import get_smoke as port_smoke
    from repro_torch.models import Model
    from repro_torch.models.convert import params_from_numpy

    cfg = get_smoke("qwen1_5_4b")
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(PARAM_KEY))
    tm = Model(port_smoke("qwen1_5_4b"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, tm, tp


def _run(models, failures):
    from repro.configs import TierScapeRunConfig as JRunConfig
    from repro.serving.engine import TieredEngine as JEngine
    from repro_torch.configs import TierScapeRunConfig
    from repro_torch.serving.engine import TieredEngine

    cfg, jm, jp, tm, tp = models
    run = dict(enabled=True, policy="analytical", window_steps=16)
    je = [JEngine(jm, jp, ts=JRunConfig(**run), **GEOM) for _ in range(2)]
    te = [TieredEngine(tm, tp, ts=TierScapeRunConfig(**run), device="cpu", **GEOM)
          for _ in range(2)]
    jev, tev = jfe.generate(jfe.TraceConfig(**BURST)), tfe.generate(tfe.TraceConfig(**BURST))
    assert tfe.digest(tev) == jfe.digest(jev)
    js = jfe.ContinuousScheduler(je, jev, cfg.vocab_size, prefill_chunk_tokens=CHUNK)
    ts = tfe.ContinuousScheduler(te, tev, cfg.vocab_size, prefill_chunk_tokens=CHUNK)
    return js.run(max_steps=600, failures=failures), ts.run(max_steps=600, failures=failures), \
        je, te, tev


@pytest.mark.parametrize("failures", [None, {20: 0}], ids=["plain", "replica0_fails_at_20"])
def test_scheduler_matches_reference_in_lockstep(models, failures):
    jstats, tstats, je, te, events = _run(models, failures)
    assert len(tstats.records) == len(jstats.records) == len(events)
    for a, b in zip(tstats.records, jstats.records):
        assert a.event.key() == b.event.key()
        for f in ("state", "replica", "slot", "place_step", "first_token_step", "done_step",
                  "chunks_left", "preemptions", "token_steps"):
            assert getattr(a, f) == getattr(b, f), (a.event.seq, f)
        assert a.request.out_tokens == b.request.out_tokens, a.event.seq
        assert a.parked is None
    assert tstats.summary() == jstats.summary()
    assert tstats.demand_windows == jstats.demand_windows
    for t, j in zip(te, je):
        np.testing.assert_array_equal(t.cache.physical, j.cache.physical)
        np.testing.assert_array_equal(t.cache.manager.placement, j.cache.manager.placement)
        for f in ("preemptions", "resumes", "resumed_pages", "re_prefill_tokens", "steps",
                  "windows", "completed"):
            assert getattr(t.stats, f) == getattr(j.stats, f), f
        assert t.cache.kernel_dispatches == j.cache.kernel_dispatches
    # The reference test's claims, on the port.
    s = tstats.summary()
    assert tstats.preemptions >= 1 and tstats.resumes >= 1 and tstats.resumed_pages >= 1
    assert tstats.re_prefill_tokens == 0
    assert len(tstats.done()) + tstats.refused == len(events)
    for rec in tstats.done():
        assert len(rec.token_steps) == rec.event.max_new_tokens
        assert (rec.tbt() >= 1).all()
        if not rec.preemptions:
            chunks = max(math.ceil(rec.event.prompt_len / CHUNK), 1)
            assert rec.first_token_step - rec.place_step == chunks - 1
    assert sum(sum(w.values()) for w in tstats.demand_windows) == tstats.decoded_tokens
    assert s["interactive"]["completed"] >= 1 and s["batch"]["completed"] >= 1
    if failures:
        assert tstats.replica_failures == 1 and tstats.failover_parked >= 1
        assert te[0].stats.preemptions >= 1  # the dead replica's slots were parked
        assert not any(te[0].slots)
    else:
        assert tstats.replica_failures == 0


def test_scheduled_demand_feeds_a_duck_typed_arbiter():
    """``feed_arbiter`` takes any object with ``record_scheduled_demand``
    (the reference's ``BudgetArbiter`` is one) and pushes the same windows,
    rekeyed onto tenant names, as the reference's ``FrontendStats``."""

    class Recorder:
        def __init__(self):
            self.windows = []

        def record_scheduled_demand(self, demand):
            self.windows.append(demand)

    windows = [{0: 120.0, 1: 30.0}, {0: 80.0, 1: 50.0}, {0: 100.0}]
    fed = []
    for mod in (jfe, tfe):
        stats = mod.FrontendStats(records=[], classes=mod.DEFAULT_CLASSES)
        stats.demand_windows = windows
        rec = Recorder()
        assert stats.feed_arbiter(rec, ("early", "late")) == 3
        assert stats.demand_by_window(("early", "late")) == rec.windows
        fed.append(rec.windows)
    assert fed[0] == fed[1]
    assert fed[1][0] == {"early": 120.0, "late": 30.0} and fed[1][2] == {"early": 100.0}


# ---------------------------------------------------------------------------
# A slot released while a pending cohort holds its pages
# ---------------------------------------------------------------------------


def _release_under_pending_cohort(pkg):
    """Slot 1's pages go to the host (staged first), slot 0's warm pages to
    the cold pool (pending behind them); slot 0 is released and reused
    before the pipeline drains."""
    if pkg == "ref":
        import jax.numpy as jnp

        from repro.configs.base import ModelConfig
        from repro.core.manager import ManagerConfig
        from repro.serving.kv_cache import COLD, HOST4, TieredKVCache
        kw, arr = {}, jnp.asarray
    else:
        from repro_torch.configs.base import ModelConfig
        from repro_torch.core.manager import ManagerConfig
        from repro_torch.serving.kv_cache import COLD, HOST4, TieredKVCache
        kw, arr = {"device": "cpu"}, torch.as_tensor
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16)
    cache = TieredKVCache(cfg, 2, 2, 8, 64, 16, ManagerConfig(policy="analytical"),
                          async_migration=True, ring_slots=8, **kw)
    k = np.random.default_rng(0).normal(0, 1, (24, 8, 2, 16)).astype(np.float32)
    cache.append_pages([(la, sl, pg) for la in range(2) for sl in range(2) for pg in range(6)],
                       arr(k), arr(k))
    r1 = [cache.rid(la, 1, p) for la in range(2) for p in range(6)]
    r0 = [cache.rid(la, 0, p) for la in range(2) for p in range(6)]
    cache.pipeline.submit(cache.plan_cohorts(np.array(r1 + r0), np.array([HOST4] * 12 +
                                                                         [COLD] * 12)))
    cache.pipeline.tick()
    cache.release_slot_pages(0)
    cache.append_pages([(la, 0, p) for la in range(2) for p in range(3)], arr(k[:6]), arr(k[:6]))
    cache.pipeline.drain()
    return cache, np.array(r0), np.array(r1)


def test_release_drains_a_pending_cohort_of_the_slot():
    """The reference drains at release only for pages in flight, so the
    pending cohort stages the freed (or reused) region ids and fails; the
    port drains first: the old pages move and are freed, the new ones land
    warm, slot 1's pages reach the host tier (ROADMAP §3)."""
    with pytest.raises(IndexError):
        _release_under_pending_cohort("ref")
    cache, r0, r1 = _release_under_pending_cohort("port")
    assert cache.physical[r0].tolist() == [1, 1, 1, 0, 0, 0] * 2  # the new request's pages
    assert set(cache.physical[r1].tolist()) == {4}
    assert not cache.pipeline.busy and cache.staging_ring.held_slots == 0


def test_scheduler_completes_where_a_small_ring_keeps_cohorts_pending(models):
    """The phase-2f trace on the SMOKE with a 4-slot staging ring: windows'
    cohorts are still pending when requests finish and their slots are
    reused. The reference's scheduler fails there (its release does not
    drain a pending cohort); the port's serves every request with zero
    re-prefill, through the replica failure."""
    from repro_torch.configs import TierScapeRunConfig
    from repro_torch.serving.engine import TieredEngine

    cfg, _, _, tm, tp = models
    ts = TierScapeRunConfig(enabled=True, alpha=0.1, window_steps=16, async_migration=True,
                            prefetch=True, faults=False, media_ring_slots=4)
    engines = [TieredEngine(tm, tp, batch_slots=2, page_tokens=16, max_seq_len=1024,
                            recent_window=32, ts=ts, device="cpu") for _ in range(2)]
    events = tfe.generate(tfe.TraceConfig(
        kind="burst", steps=64, rate=0.06, seed=3, sla_mix=(0.85, 0.15), burst_every=24,
        burst_len=4, burst_mult=8.0, burst_sla=1, prompt_len=(200, 400), new_tokens=(16, 32),
        n_tenants=2, tenant_mix=(0.8, 0.2), tenant_flip_step=32))
    stats = tfe.ContinuousScheduler(engines, events, cfg.vocab_size,
                                    prefill_chunk_tokens=64).run(failures={40: 0})
    assert len(stats.done()) == len(events) and stats.refused == 0
    assert stats.re_prefill_tokens == 0 and stats.failover_parked >= 1
    assert stats.preemptions >= 1 and stats.resumes >= 1
    assert all(len(r.request.out_tokens) == r.event.max_new_tokens for r in stats.done())
    for e in engines:
        assert not e.cache.pipeline.busy and e.cache.staging_ring.held_slots == 0
