"""Preemption to the host tier in the port's cache and engine, in lockstep
with the JAX package, on the CPU.

The four engine-hook tests of ``tests/test_frontend.py`` run on both
packages' engines (``qwen1_5_4b`` SMOKE, weights carried across from the
reference's init; the reference test's geometry):

  * a request preempted after 5 steps, with another request churning the
    vacated slot, resumes into the OTHER slot and produces the tokens of an
    uninterrupted run, bit for bit, in both packages, with zero re-prefilled
    tokens; right after the restore, each pool's table rows of the resumed
    slot hold its pages in the uninterrupted run's order (the split
    attention kernel merges a sequence's rows in table order);
  * the preemption demotion bills the media queues (bytes, ops, busy time)
    and the kernel-dispatch counter exactly like a plain pipeline demotion
    of the same pages, and like the reference's;
  * after park the slot is empty everywhere, after restore its placements
    are the pre-preemption ones, in both packages;
  * ``token_capacity``, ``device_headroom_tokens``, ``outstanding_tokens``
    and ``try_submit`` equal the reference's.

Plus a resume into another engine of the same geometry (what a replica
failover does) and the hybrid (``zamba2_1_2b`` SMOKE): tokens equal to the
reference's and to an uninterrupted run, and the SSM side state carried
through the preemption bit for bit, held to the reference's at
``test_torch_hybrid.py``'s ``CACHE_TOL``.

Tolerances: tokens, placements, table rows and billing are compared
exactly; the hybrid's SSM side state against the reference at CACHE_TOL
(atol 0.125, rtol 2^-5). The parameter key and prompt seeds were checked to
keep greedy decoding clear of bf16 ties (at ``PRNGKey(0)`` the reference
test's prompt meets a one-ulp tie at decode step 17, ROADMAP §3; at
``PRNGKey(4)`` it does not).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import TierScapeRunConfig as JRunConfig  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving.engine import TieredEngine as JEngine  # noqa: E402
from repro_torch.configs import TierScapeRunConfig, get_smoke as port_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import TieredEngine  # noqa: E402
from repro_torch.serving.kv_cache import COLD, HOST4, HOST8, WARM  # noqa: E402

GEOM = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
PARAM_KEY = 4
PROMPT_SEED = 7  # the reference test's; at PRNGKey(0) it meets a one-ulp tie
HYBRID_PROMPT_SEED = 24
# test_torch_hybrid.py: eight bf16 ulps, the recurrent prefill's cache bar.
CACHE_TOL = dict(atol=0.125, rtol=2.0**-5)


def _pair(arch):
    cfg = get_smoke(arch)
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(PARAM_KEY))
    tm = Model(port_smoke(arch), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen1_5_4b")


# A transient error and a corruption on the first staged read of every
# window from either medium (recovered: retried, and repaired from the host
# copy the CRC check keeps).
MEDIA_FAULTS = [(kind, dev, 0, 99) for kind in ("transient", "corrupt")
                for dev in ("hbm", "host_dram_pcie")]


def _engines(pair, window_steps=10_000, faults=(), **run):
    """(reference engine, port engine) with the reference test's settings;
    ``faults`` lists (kind, device, window0, window1) events for both."""
    from repro.media.faults import FaultEvent as JEvent, FaultPlan as JPlan
    from repro_torch.media.faults import FaultEvent, FaultPlan

    cfg, jm, jp, tm, tp = pair
    kw = dict(enabled=True, policy="analytical", window_steps=window_steps, **run)
    jplan = JPlan([JEvent(*e) for e in faults]) if faults else None
    tplan = FaultPlan([FaultEvent(*e) for e in faults]) if faults else None
    return (JEngine(jm, jp, ts=JRunConfig(**kw, fault_plan=jplan), **GEOM),
            TieredEngine(tm, tp, ts=TierScapeRunConfig(**kw, fault_plan=tplan), device="cpu",
                         **GEOM))


def _table_pages(cache, slot):
    """Logical page indices of ``slot``'s rows, per (pool, layer), in table
    order (works on either package's cache)."""
    st = cache.state
    out = {}
    for pool, levels, owner in (("warm", (WARM,), cache._pool_slot),
                                ("cold", (COLD,), cache._pool_slot),
                                ("host", (HOST8, HOST4), cache._host_slot)):
        table = np.asarray(getattr(st, f"{pool}_table"))
        count = np.asarray(getattr(st, f"{pool}_n"))
        for layer in range(cache.la):
            rids = [cache.rid(layer, slot, p) for p in range(cache.max_pages)]
            lookup = {int(owner[r]): r % cache.max_pages for r in rids
                      if cache._page_exists[r] and int(cache.physical[r]) in levels}
            rows = table[layer, slot, :int(count[layer, slot])]
            out[(pool, layer)] = [lookup[int(x)] for x in rows]
    return out


def _prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, cfg.vocab_size, 24).astype(np.int32),
            rng.integers(1, cfg.vocab_size, 12).astype(np.int32))


def _uninterrupted(eng, prompt, steps_snapshot=5):
    req = eng.make_request(prompt, 20)
    eng.start_request(0, req)
    snap = None
    for i in range(10_000):
        if req.done:
            break
        if i == steps_snapshot:
            snap = _table_pages(eng.cache, 0)
        eng.step()
    return req, snap


def _preempted(eng, prompt, other_prompt, target=None):
    """Preempt after 5 steps, churn the vacated slot, resume into slot 1
    (of ``target`` if given: a second engine of the same geometry)."""
    req = eng.make_request(prompt, 20)
    eng.start_request(0, req)
    for _ in range(5):
        eng.step()
    pre = eng.preempt_slot(0)
    other = eng.make_request(other_prompt, 6)
    eng.start_request(0, other)
    while not other.done:
        eng.step()
    target = target or eng
    target.resume_into(1, pre)
    restored = _table_pages(target.cache, 1)
    while not req.done:
        target.step()
    return req, pre, restored, target.finish()


def test_request_rids_are_monotonic_across_queue_churn(qwen):
    _, te = _engines(qwen)
    p = np.random.default_rng(0).integers(1, 256, 8).astype(np.int32)
    a, b = te.submit(p, 4), te.submit(p, 4)
    te.queue.clear()
    c, d = te.submit(p, 4), te.make_request(p, 4)
    assert [a.rid, b.rid, c.rid, d.rid] == [0, 1, 2, 3]


def test_preempt_resume_bit_identical_zero_reprefill(qwen):
    cfg = qwen[0]
    prompt, other = _prompts(cfg, PROMPT_SEED)
    out = {}
    for name, (ea, eb) in (("ref", (_engines(qwen)[0], _engines(qwen)[0])),
                           ("port", (_engines(qwen)[1], _engines(qwen)[1]))):
        ra, snap = _uninterrupted(ea, prompt)
        rb, pre, restored, stats = _preempted(eb, prompt, other)
        assert len(pre.parked.pages) > 0
        assert all(pg.host_level in (HOST8, HOST4) for pg in pre.parked.pages)
        assert any(pg.restore_level in (WARM, COLD) for pg in pre.parked.pages)
        assert rb.out_tokens == ra.out_tokens, name
        assert stats.re_prefill_tokens == 0
        assert stats.preemptions == 1 and stats.resumes == 1
        assert stats.resumed_pages == len(pre.parked.pages)
        assert restored == snap, name  # table rows in the uninterrupted run's order
        out[name] = (ra.out_tokens, [(pg.layer, pg.page, pg.host_level, pg.restore_level)
                                     for pg in pre.parked.pages], eb.cache.kernel_dispatches)
    assert out["port"] == out["ref"]
    # The parked recent window is a host copy (it outlives the device buffer).
    _, te = _engines(qwen)
    _, pre, _, _ = _preempted(te, prompt, other)
    assert pre.parked.recent_k.device.type == "cpu"
    assert pre.parked.recent_k.dtype == te.cache.state.recent_k.dtype


def test_resume_into_another_engine_is_bit_identical(qwen):
    """A parked request restores into a second engine of the same geometry
    (the replica failover path) and finishes with the uninterrupted tokens,
    in both packages."""
    cfg = qwen[0]
    prompt, other = _prompts(cfg, PROMPT_SEED)
    toks = {}
    for i, name in ((0, "ref"), (1, "port")):
        ra, _ = _uninterrupted(_engines(qwen)[i], prompt)
        src, dst = _engines(qwen)[i], _engines(qwen)[i]
        rb, pre, _, stats = _preempted(src, prompt, other, target=dst)
        assert rb.out_tokens == ra.out_tokens, name
        assert stats.resumes == 1 and stats.resumed_pages == len(pre.parked.pages)
        assert src.cache.slot_rids(1).size == 0
        toks[name] = rb.out_tokens
    assert toks["port"] == toks["ref"]


def _billing(cache):
    return {name: (q.bytes_total, q.ops, round(q.busy_s, 12))
            for name, q in cache.media_queues.items()}


def test_preemption_bills_like_plain_demotion(qwen):
    """With the host media clean and under injected faults (a transient
    error and a corruption, both recovered), the preemption demotion bills
    like a plain demotion, in both packages: faults stay billing-neutral."""
    cfg = qwen[0]
    prompt = np.random.default_rng(11).integers(1, cfg.vocab_size, 32).astype(np.int32)
    snaps, physical, fault_counts = {}, {}, {}
    for faults in (False, True):
        for i, pkg in ((0, "ref"), (1, "port")):
            for mode in ("plain", "preempt"):
                eng = _engines(qwen, faults=MEDIA_FAULTS if faults else ())[i]
                req = eng.make_request(prompt, 4)
                eng.start_request(0, req)
                cache = eng.cache
                before, disp = _billing(cache), cache.kernel_dispatches
                if mode == "plain":
                    rids = cache.slot_rids(0)
                    dev = rids[np.isin(cache.physical[rids], (WARM, COLD))]
                    bits = np.array([cache._bits[int(s)] for s in cache.physical[dev]])
                    dsts = np.where(bits == 8, HOST8, HOST4).astype(np.int64)
                    cache.pipeline.submit(cache.plan_cohorts(dev, dsts))
                    cache.pipeline.drain()
                else:
                    levels = cache.demote_slot_to_host(0)
                    assert levels and all(v in (WARM, COLD) for v in levels.values())
                after = _billing(cache)
                key = (faults, pkg, mode)
                snaps[key] = ({n: tuple(np.subtract(after[n], before[n])) for n in after},
                              cache.kernel_dispatches - disp)
                physical[key] = cache.physical.copy()
                fault_counts[key] = (cache.pipeline.fault_retries,
                                     cache.pipeline.corruptions_detected)
                assert bool(np.isin(cache.physical[cache.slot_rids(0)], (HOST8, HOST4)).all())
    assert all(v == snaps[False, "ref", "plain"] for v in snaps.values())
    assert snaps[False, "port", "preempt"][0]["host_dram_pcie"][0] > 0  # real bytes moved
    assert all(np.array_equal(v, physical[False, "ref", "plain"]) for v in physical.values())
    for mode in ("plain", "preempt"):
        assert fault_counts[True, "port", mode] == fault_counts[True, "ref", mode]
    assert fault_counts[True, "port", "preempt"] == fault_counts[True, "port", "plain"]
    assert min(fault_counts[True, "port", "preempt"]) > 0  # both faults fired


def test_park_restore_table_invariants(qwen):
    cfg = qwen[0]
    prompt = np.random.default_rng(13).integers(1, cfg.vocab_size, 40).astype(np.int32)
    seen = {}
    for i, pkg in ((0, "ref"), (1, "port")):
        eng = _engines(qwen)[i]
        req = eng.make_request(prompt, 4)
        eng.start_request(0, req)
        cache = eng.cache
        rids_before = cache.slot_rids(0)
        phys_before = cache.physical[rids_before].copy()
        rows_before = _table_pages(cache, 0)
        assert rids_before.size > 0
        pre = eng.preempt_slot(0)
        assert cache.slot_rids(0).size == 0
        assert not any(int(r) in cache.host_pages for r in rids_before)
        st = cache.state
        for f in ("warm_n", "cold_n", "host_n"):
            assert int(np.asarray(getattr(st, f))[:, 0].sum()) == 0, f
        assert int(st.recent_len[0]) == 0 and int(st.total_len[0]) == 0
        assert eng.free_slots() == [0, 1]
        parked = [(pg.layer, pg.page, pg.host_level, pg.restore_level) for pg in pre.parked.pages]
        eng.resume_into(0, pre)
        rids_after = cache.slot_rids(0)
        assert np.array_equal(rids_after, rids_before)
        assert np.array_equal(cache.physical[rids_after], phys_before)
        assert _table_pages(cache, 0) == rows_before
        assert int(cache.state.total_len[0]) == int(eng.slot_len[0])
        seen[pkg] = (parked, cache.physical.copy(), pre.parked.recent_len, pre.parked.total_len)
    assert seen["port"][0] == seen["ref"][0]
    assert np.array_equal(seen["port"][1], seen["ref"][1])
    assert seen["port"][2:] == seen["ref"][2:]


def test_preempt_and_resume_refuse_misuse(qwen):
    _, te = _engines(qwen)
    with pytest.raises(ValueError, match="no active request"):
        te.preempt_slot(0)
    prompt = np.random.default_rng(13).integers(1, 256, 40).astype(np.int32)
    req = te.make_request(prompt, 4)
    te.start_request(0, req)
    with pytest.raises(ValueError, match="device-resident"):
        te.cache.park_slot(0)
    pre = te.preempt_slot(0)
    te.start_request(0, te.make_request(prompt, 4))
    with pytest.raises(ValueError, match="occupied"):
        te.resume_into(0, pre)
    with pytest.raises(ValueError, match="still holds pages"):
        te.cache.restore_slot(0, pre.parked)


def test_token_accounting_and_try_submit_match_reference(qwen):
    cfg = qwen[0]
    je, te = _engines(qwen)
    rng = np.random.default_rng(5)
    for eng in (je, te):
        assert eng.token_capacity() > 0
    assert te.token_capacity() == je.token_capacity()
    seq = [(rng.integers(1, cfg.vocab_size, n).astype(np.int32), g)
           for n, g in ((30, 6), (12, 8), (40, 5))]
    for i, (prompt, gen) in enumerate(seq):
        jr, tr = je.make_request(prompt, gen), te.make_request(prompt, gen)
        je.start_request(i % 2, jr) if i < 2 else je.queue.append(jr)
        te.start_request(i % 2, tr) if i < 2 else te.queue.append(tr)
        for f in ("free_slots", "token_capacity", "device_headroom_tokens",
                  "outstanding_tokens"):
            assert getattr(te, f)() == getattr(je, f)(), (i, f)
    je.step()
    te.step()
    assert te.outstanding_tokens() == je.outstanding_tokens()
    assert te.device_headroom_tokens() == je.device_headroom_tokens()
    # try_submit: admitted under budget, refused (and not queued) over it.
    cap = te.token_capacity()
    for eng in (je, te):
        n = len(eng.queue)
        assert eng.try_submit(np.ones(8, np.int32), 8) is not None
        assert eng.try_submit(np.ones(16, np.int32), cap) is None
        assert eng.try_submit(np.ones(8, np.int32), 8, budget_frac=0.0) is None
        assert len(eng.queue) == n + 1


# ---------------------------------------------------------------------------
# The hybrid: SSM side state through preempt/resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zamba():
    return _pair("zamba2_1_2b")


def _host_f32(x) -> np.ndarray:
    """An f32 numpy copy (the engines write their side state in place)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy().copy()
    return np.array(x, np.float32)


def test_hybrid_preempt_resume_carries_ssm_state(zamba):
    cfg = zamba[0]
    prompt, other = _prompts(cfg, HYBRID_PROMPT_SEED)
    out = {}
    for i, name in ((0, "ref"), (1, "port")):
        ra, _ = _uninterrupted(_engines(zamba)[i], prompt)
        eng = _engines(zamba)[i]
        req = eng.make_request(prompt, 20)
        eng.start_request(0, req)
        for _ in range(5):
            eng.step()
        side_before = [_host_f32(a[:, 0]) for a in eng.ssm_state]
        pre = eng.preempt_slot(0)
        o = eng.make_request(other, 6)
        eng.start_request(0, o)
        while not o.done:
            eng.step()
        eng.resume_into(1, pre)
        side_after = [_host_f32(a[:, 1]) for a in eng.ssm_state]
        for a, b in zip(side_before, side_after):
            np.testing.assert_array_equal(b, a)  # carried bit for bit
        while not req.done:
            eng.step()
        stats = eng.finish()
        assert req.out_tokens == ra.out_tokens, name
        assert stats.re_prefill_tokens == 0 and stats.resumes == 1
        out[name] = (req.out_tokens, side_after)
    assert out["port"][0] == out["ref"][0]
    for t, j in zip(out["port"][1], out["ref"][1]):
        np.testing.assert_allclose(t, j, **CACHE_TOL)
    assert isinstance(pre.ssm_conv, torch.Tensor) and pre.ssm_conv.device.type == "cpu"
