"""The port's tiered serving loop against the JAX package, on the CPU.

Both engines run on the ``qwen1_5_4b`` smoke config (weights carried across
from the reference's init), 2 slots and 3 requests so slots get reused, and
step in lockstep: greedy tokens, physical and desired placements, migrations
and billed attention launches must be equal — with the serial migration
executor, and in the five modes of the async media pipeline (async, async +
prefetch, ``faults=True``, a ``seeded_storm`` fault plan, and host tiers on
``cxl_hw``), where the pipeline's overlap and prefetch counters, the
kernel-dispatch bill and every media queue's busy time and bytes must agree
too. Logits of one tiered decode step from the same converted state are held
to the model test's bf16 tolerance (see ``test_torch_model.py``); per-page
hotness to 2e-4.

The prompt seeds were checked to keep greedy decoding clear of exact ties:
the reference's bf16 logits can tie (margin 0.0) where the port's differ by
one ulp, which flips argmax (ROADMAP §3).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ParallelConfig  # noqa: E402
from repro.configs import TierScapeRunConfig as JRunConfig  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.media.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro.serving.engine import TieredEngine as JEngine  # noqa: E402
from repro_torch.configs import TierScapeRunConfig, get_smoke as port_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.media.faults import FaultPlan  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402
from repro_torch.serving.engine import TieredEngine  # noqa: E402

LOGIT_ATOL = 0.0625  # four bf16 ulps at |logit| < 4 (test_torch_model.py)
HOT_TOL = dict(rtol=2e-4, atol=2e-4)
ENGINE = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
# alpha 0.1 spreads pages over warm int8, cold int4 and the int4 host tier,
# so windows run transcoding cohorts, host sentinels and swap-ins.
RUN = dict(enabled=True, policy="analytical", alpha=0.1, window_steps=6,
           async_migration=False, prefetch=False, faults=False)
PARAM_KEY, PROMPT_SEED, NEW_TOKENS = 0, 1, 20


@pytest.fixture(scope="module")
def models():
    cfg = get_smoke("qwen1_5_4b")
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(PARAM_KEY))
    tm = Model(port_smoke("qwen1_5_4b"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def lockstep(models):
    cfg, jm, jp, tm, tp = models
    je = JEngine(jm, jp, ts=JRunConfig(**RUN), **ENGINE)
    te = TieredEngine(tm, tp, ts=TierScapeRunConfig(**RUN), device="cpu", **ENGINE)
    rng = np.random.default_rng(PROMPT_SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (40, 27, 33)]
    jreqs = [je.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    treqs = [te.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    windows, snapshot = [], None
    while any(s is not None for s in je.slots) or je.queue:
        assert je.stats.steps < 100
        je._fill_slots()
        te._fill_slots()
        if je.stats.windows == 2 and snapshot is None:
            tokens = np.zeros((ENGINE["batch_slots"], 1), np.int32)
            for i, r in enumerate(je.slots):
                if r is not None:
                    tokens[i, 0] = r.out_tokens[-1]
            snapshot = (je.cache.state, tokens)
        je.step()
        te.step()
        if te.stats.windows > len(windows):
            windows.append(dict(
                jphys=je.cache.physical.copy(), tphys=te.cache.physical.copy(),
                jplace=je.cache.manager.placement.copy(),
                tplace=te.cache.manager.placement.copy(),
                jsteps=je.stats.steps, tsteps=te.stats.steps,
            ))
    return types.SimpleNamespace(
        cfg=cfg, jm=jm, jp=jp, tm=tm, tp=tp, je=je, te=te, jreqs=jreqs, treqs=treqs,
        jstats=je.finish(), tstats=te.finish(), windows=windows, snapshot=snapshot,
    )


def test_engine_tokens_placements_and_counters_match_reference(lockstep):
    ls = lockstep
    assert [r.out_tokens for r in ls.treqs] == [r.out_tokens for r in ls.jreqs]
    assert all(len(r.out_tokens) == NEW_TOKENS and r.done for r in ls.treqs)
    assert len(ls.windows) == ls.jstats.windows >= 5
    for i, w in enumerate(ls.windows):
        assert w["tsteps"] == w["jsteps"]
        np.testing.assert_array_equal(w["tphys"], w["jphys"], err_msg=f"window {i + 1}")
        np.testing.assert_array_equal(w["tplace"], w["jplace"], err_msg=f"window {i + 1}")
    levels = np.concatenate([w["tphys"] for w in ls.windows])
    assert {1, 2, 4} <= set(levels.tolist())  # warm, cold and host pages all occurred
    for f in ("steps", "windows", "migrations", "completed", "attn_launches"):
        assert getattr(ls.tstats, f) == getattr(ls.jstats, f), f
    assert ls.tstats.migrations > 0
    assert ls.tstats.attn_launches == ls.cfg.n_layers * ls.tstats.steps
    assert ls.te.cache.kernel_dispatches == ls.je.cache.kernel_dispatches
    assert ls.tstats.tco_savings_pct == pytest.approx(ls.jstats.tco_savings_pct, rel=1e-12)


def _port_state(jstate):
    return serve.TieredKVState(**{
        f.name: tensor_from_numpy(np.asarray(getattr(jstate, f.name)))
        for f in dataclasses.fields(serve.TieredKVState)
    })


@pytest.mark.parametrize("route", ["fused", "per_pool"])
def test_tiered_decode_step_matches_reference(lockstep, route):
    """One decode step from the same (converted) mid-run state with warm,
    cold and host pages, on both attention routes (the kernels' plain
    versions on the CPU), against the reference's step function. The
    reference step runs eagerly, op by op, so that it rounds to bf16 where
    PyTorch does (the engine's jitted step keeps excess f32 precision across
    fused ops, which moves q by up to a bf16 ulp and a page's hotness by
    ~5e-3 relative)."""
    ls = lockstep
    jstate, tokens = ls.snapshot
    assert int(np.asarray(jstate.warm_n).sum()) > 0 and int(np.asarray(jstate.host_n).sum()) > 0
    jstep = jserve.make_tiered_decode_step(
        ls.jm, make_mesh((1, 1), ("data", "model")), ParallelConfig(), JRunConfig(**RUN),
        use_kernels=False)
    jl, jtkv, _, jtel = jstep(ls.jp, jnp.asarray(tokens), jstate, ls.je.ssm_state)
    step = serve.make_tiered_decode_step(ls.tm, TierScapeRunConfig(**RUN), device="cpu")
    ops.use_fused(route == "fused")
    try:
        tl, ttkv, _, ttel = step(ls.tp, torch.as_tensor(tokens), _port_state(jstate), None)
    finally:
        ops.use_fused(True)
    assert tl.shape == (ENGINE["batch_slots"], 1, ls.cfg.vocab_size)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl.astype(jnp.float32)),
                               atol=LOGIT_ATOL, rtol=0)
    for k in ("warm", "cold", "host"):
        np.testing.assert_allclose(ttel[k].numpy(), np.asarray(jtel[k]), err_msg=k, **HOT_TOL)
    np.testing.assert_array_equal(ttkv.recent_len.numpy(), np.asarray(jtkv.recent_len))
    np.testing.assert_array_equal(ttkv.total_len.numpy(), np.asarray(jtkv.total_len))


def test_engine_tracks_dense_reference_tokens():
    """The reference's own bar (tests/test_system.py), on the port: tiered
    decoding keeps >= 6 of 8 greedy tokens of the port's dense model."""
    cfg = port_smoke("qwen1_5_4b")
    model = Model(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, JModel(get_smoke("qwen1_5_4b")).init(
        jax.random.PRNGKey(1))))
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, 24)
    state = model.init_cache(1, 64)
    logits, state = model.prefill(params, {"tokens": torch.as_tensor(prompt[None])}, state)
    ref_tokens = [int(torch.argmax(logits[0, -1]))]
    for _ in range(7):
        lg, state = model.decode_step(params, torch.as_tensor([[ref_tokens[-1]]]), state)
        ref_tokens.append(int(torch.argmax(lg[0, 0])))
    eng = TieredEngine(model, params, batch_slots=1, page_tokens=8, max_seq_len=64,
                       recent_window=16, device="cpu",
                       ts=TierScapeRunConfig(enabled=True, window_steps=32,
                                             async_migration=False, prefetch=False))
    req = eng.submit(prompt, max_new_tokens=8)
    eng.run(max_steps=16)
    assert sum(a == b for a, b in zip(req.out_tokens, ref_tokens)) >= 6


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = port_smoke("qwen1_5_4b")
    model = Model(cfg, device="cpu")
    params = model.init(0)
    ts = TierScapeRunConfig(enabled=True, async_migration=False, prefetch=False)
    with pytest.raises(RuntimeError, match="cuda"):
        TieredEngine(model, params, ts=ts)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.make_tiered_decode_step(model, ts)


# The engine's default is async migration with prefetch; each mode below
# changes one option of it (or turns prefetch off).
ASYNC = dict(RUN, async_migration=True, prefetch=True)
MODES = {
    "async": dict(prefetch=False),
    "async_prefetch": {},
    "faults": dict(faults=True),
    "storm": dict(fault_plan="storm"),
    "cxl_hw": dict(host_media_device="cxl_hw"),
}
MODE_PROMPT_SEED = 2


def _run_config(cls, plan_cls, change):
    kw = dict(ASYNC, **change)
    if kw.get("fault_plan") == "storm":
        kw["fault_plan"] = plan_cls.seeded_storm("host_dram_pcie", seed=3, windows=8)
    return cls(**kw)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_mode_matches_reference(models, mode):
    """The async pipeline in lockstep with the JAX engine: tokens, physical
    and desired placements after every step, the stats counters, the
    pipeline's fault counters, the kernel-dispatch bill, and each media
    queue's busy seconds and bytes (modeled time, rel 1e-12)."""
    cfg, jm, jp, tm, tp = models
    je = JEngine(jm, jp, ts=_run_config(JRunConfig, JFaultPlan, MODES[mode]), **ENGINE)
    te = TieredEngine(tm, tp, ts=_run_config(TierScapeRunConfig, FaultPlan, MODES[mode]),
                      device="cpu", **ENGINE)
    rng = np.random.default_rng(MODE_PROMPT_SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (40, 27, 33)]
    jreqs = [je.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    treqs = [te.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    while any(s is not None for s in je.slots) or je.queue:
        assert je.stats.steps < 100
        je._fill_slots()
        te._fill_slots()
        je.step()
        te.step()
        step = je.stats.steps
        np.testing.assert_array_equal(te.cache.physical, je.cache.physical, err_msg=f"step {step}")
        np.testing.assert_array_equal(te.cache.manager.placement, je.cache.manager.placement,
                                      err_msg=f"step {step}")
    js, ts = je.finish(), te.finish()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == NEW_TOKENS and r.done for r in treqs)
    for f in ("steps", "windows", "migrations", "completed", "overlapped_steps",
              "prefetch_staged", "prefetch_hits", "prefetch_misses", "attn_launches"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.overlapped_steps > 0 and ts.migrations > 0
    assert ts.prefetch_staged == ts.prefetch_hits + ts.prefetch_misses
    # The reference has no count of held pages invalidated under their
    # shadow copy (the port's ``prefetch_invalidated``): there they are the
    # staged pages that met no boundary.
    tp, jp = te.cache.pipeline, je.cache.pipeline
    assert tp.prefetch_invalidated == jp.prefetch_staged - jp.prefetch_hits - jp.prefetch_misses
    assert tp.prefetch_cancelled == jp.prefetch_cancelled
    assert tp.prefetch_hit_rate() == jp.prefetch_hit_rate()
    assert te.cache.kernel_dispatches == je.cache.kernel_dispatches
    for f in ("fault_retries", "cohorts_aborted", "corruptions_injected",
              "corruptions_detected", "corruptions_repaired", "pages_moved", "cohorts_done"):
        assert getattr(te.cache.pipeline, f) == getattr(je.cache.pipeline, f), f
    assert te.cache.fault_deferred_pages == je.cache.fault_deferred_pages
    assert set(te.cache.media_queues) == set(je.cache.media_queues)
    for name, jq in je.cache.media_queues.items():
        tq = te.cache.media_queues[name]
        assert tq.bytes_total == jq.bytes_total, name
        assert tq.busy_s == pytest.approx(jq.busy_s, rel=1e-12), name
    ring = te.cache.staging_ring
    assert ring.held_slots == 0 and ring.free_slots == ring.n_slots
    if mode == "faults":
        assert te.cache.pipeline.fault_retries > 0
        assert te.cache.pipeline.corruptions_detected > 0


def test_unported_family_raises():
    """What the engine and the tiered step still refuse, with ValueError at
    construction: an encoder (no decode), the attention-free SSM family (the
    reference's message) and an unknown family."""
    cfg = port_smoke("qwen1_5_4b")
    ts = TierScapeRunConfig(enabled=True)
    for change, match in ((dict(family="encoder", causal=False), "encoder"),
                          (dict(family="ssm"), "attention layers"),
                          (dict(family="retnet"), "retnet")):
        model = types.SimpleNamespace(cfg=dataclasses.replace(cfg, **change),
                                      device=torch.device("cpu"))
        with pytest.raises(ValueError, match=match):
            TieredEngine(model, {}, ts=ts, device="cpu")
        with pytest.raises(ValueError, match=match):
            serve.make_tiered_decode_step(model, ts, device="cpu")


def test_tiered_step_refuses_layernorm():
    """The tiered step's norms are the ``rmsnorm`` kernel: a model that takes
    LayerNorm is refused with ValueError at construction."""
    cfg = dataclasses.replace(port_smoke("qwen1_5_4b"), norm="layernorm")
    with pytest.raises(ValueError, match="RMSNorm"):
        serve.make_tiered_decode_step(Model(cfg, device="cpu"), TierScapeRunConfig(enabled=True),
                                      device="cpu")


# ---------------------------------------------------------------------------
# The cache's per-page path (the batched executor's oracle) vs the reference
# ---------------------------------------------------------------------------

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16)


def _caches(warm_frac=0.5):
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.core.manager import ManagerConfig as JManagerConfig
    from repro.serving.kv_cache import TieredKVCache as JCache
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.manager import ManagerConfig
    from repro_torch.serving.kv_cache import TieredKVCache

    j = JCache(JModelConfig(**TINY), 2, 2, 8, 64, 16,
               JManagerConfig(policy="analytical", alpha=0.5), warm_frac=warm_frac)
    t = TieredKVCache(ModelConfig(**TINY), 2, 2, 8, 64, 16,
                      ManagerConfig(policy="analytical", alpha=0.5), warm_frac=warm_frac,
                      device="cpu")
    return j, t


def _content(cache):
    """{rid: (level, k_pay, k_sc, v_pay, v_sc)} from wherever each page lives."""
    out = {}
    for rid in np.where(cache._page_exists)[0]:
        rid = int(rid)
        level = int(cache.physical[rid])
        layer = rid // (cache.bs * cache.max_pages)
        if level in (1, 2):
            cls = cache._cls["warm" if level == 1 else "cold"]
            ps = int(cache._pool_slot[rid])
            item = [getattr(cache.state, f"{cls}_{f}")[layer, ps]
                    for f in ("k", "k_scales", "v", "v_scales")]
        else:
            item = cache.host_pages[rid]
        out[rid] = (level, *(np.asarray(x) for x in item))
    return out


def _assert_same(a, b):
    np.testing.assert_array_equal(a.physical, b.physical)
    np.testing.assert_array_equal(a.manager.placement, b.manager.placement)
    ca, cb = _content(a), _content(b)
    assert ca.keys() == cb.keys()
    for rid in ca:
        assert ca[rid][0] == cb[rid][0], rid
        for i in (1, 3):  # payloads byte-equal
            np.testing.assert_array_equal(ca[rid][i], cb[rid][i], err_msg=f"rid {rid}")
        for i in (2, 4):  # scales: the per-page path requantizes (1-2 ulp noise)
            np.testing.assert_allclose(ca[rid][i], cb[rid][i], rtol=1e-6, err_msg=f"rid {rid}")
    assert set(a.host_pages) == set(b.host_pages)


def _plan(cache, rng):
    live = np.where(cache._page_exists)[0]
    rids = rng.choice(live, size=max(len(live) // 3, 1), replace=False)
    dsts = np.array([rng.choice([d for d in (1, 2, 3, 4) if d != cache.physical[r]])
                     for r in rids], np.int64)
    budget = len(cache._alloc["warm"]._free) + int((cache.physical[rids] == 1).sum())
    dsts[np.where(dsts == 1)[0][budget:]] = 2  # no warm pressure inside the plan
    return rids, dsts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_page_migration_matches_reference_and_batched_executor(seed):
    """The port's per-page ``migrate`` loop equals the reference's per-page
    loop, and both equal the port's ``migrate_batch`` on the same plans."""
    rng = np.random.default_rng(seed)
    j, t = _caches()
    _, tb = _caches()
    n = 40
    coords = [(la, sl, pg) for la in range(2) for sl in range(2) for pg in range(8)][:n]
    k = rng.normal(0, 1, (n, 8, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (n, 8, 2, 16)).astype(np.float32)
    j.append_pages(coords, jnp.asarray(k), jnp.asarray(v))
    for c in (t, tb):
        c.append_pages(coords, torch.from_numpy(k), torch.from_numpy(v))
    _assert_same(j, t)
    for _ in range(3):
        rids, dsts = _plan(t, rng)
        for r, d in zip(rids, dsts):
            j.migrate(int(r), int(d))
            t.migrate(int(r), int(d))
        assert tb.migrate_batch(rids, dsts) == len(rids)
        _assert_same(j, t)
        _assert_same(t, tb)
    assert t.kernel_dispatches == j.kernel_dispatches


def test_append_page_evicts_coldest_warm_like_reference():
    """Single-page ingestion past the warm pool's capacity: the coldest warm
    page (by the averaged telemetry) is demoted per page, then pages spill
    to the cold tier — the same victims and placements as the reference."""
    rng = np.random.default_rng(5)
    j, t = _caches(warm_frac=0.0)  # warm holds its minimum of 8 pages
    coords = [(la, sl, pg) for la in range(2) for sl in range(2) for pg in range(5)]
    for i, (la, sl, pg) in enumerate(coords):
        kp = rng.normal(0, 1, (8, 2, 16)).astype(np.float32)
        vp = rng.normal(0, 1, (8, 2, 16)).astype(np.float32)
        j.append_page(la, sl, pg, jnp.asarray(kp), jnp.asarray(vp))
        t.append_page(la, sl, pg, torch.from_numpy(kp), torch.from_numpy(vp))
        if i % 4 == 3:  # close a window so the victims follow real hotness
            counts = rng.random(j.n_regions) * 100.0
            for c in (j, t):
                c.manager.record_access_counts(counts)
                c.manager.telemetry.close_window()
    assert int((t.physical == 2).sum()) > 0 and int((t.physical == 1).sum()) == 8
    _assert_same(j, t)
