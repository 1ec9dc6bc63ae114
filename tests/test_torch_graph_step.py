"""The captured decode step's plumbing (``runtime.graph.GraphedStep``) on the
CPU, against the eager step and the JAX engine.

On the card the engine captures its tiered decode step once as a CUDA graph
and replays it per token. The CPU has no graph, so ``GraphedStep`` runs the
same static-buffer plumbing there and a replay runs the eager step on the
static inputs, writing its results into the static outputs as a graph
would. These tests drive that plumbing inside the port's engine, on the
``qwen1_5_4b`` SMOKE, in lockstep with the JAX engine: three windows with
page-outs, window-boundary migrations, a preemption and a resume, and a
table edit by hand between steps. Every step's logits, telemetry and new
state must be byte-equal to the eager step's on the same inputs, no tensor
handed back may share memory with the static buffers, and the greedy tokens
and the per-window placements must equal the JAX engine's (as
``test_torch_engine.py`` holds them; same weights, prompt seed 1, checked
clear of bf16 ties). Also: a route change and a moved class buffer capture
again, the launch accounting of a capture and a replay, and the table check
that replaces the step's class-bounds check.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import TierScapeRunConfig as JRunConfig  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving.engine import TieredEngine as JEngine  # noqa: E402
from repro_torch.configs import TierScapeRunConfig, get_smoke as port_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime import graph  # noqa: E402
from repro_torch.runtime.serve import TieredKVState  # noqa: E402
from repro_torch.serving.engine import TieredEngine  # noqa: E402
from repro_torch.serving.kv_cache import COLD, WARM  # noqa: E402

ENGINE = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
RUN = dict(enabled=True, policy="analytical", alpha=0.1, window_steps=5,
           async_migration=False, prefetch=False, faults=False)
PARAM_KEY, PROMPT_SEED, NEW_TOKENS = 0, 1, 14
PREEMPT_AT, RESUME_AFTER, EDIT_AT = 5, 2, 9  # engine steps


class CheckedStep:
    """The engine's step: ``GraphedStep``'s result, held byte-equal to the
    eager step's on the same inputs."""

    def __init__(self, eager):
        self.eager = eager
        self.graphed = graph.GraphedStep(eager, "cpu")
        self.steps = 0

    def static_storage(self):
        ptrs = set()
        for g in self.graphed.graphs.values():
            tensors = [g.token, *(getattr(g.tkv, f) for f in graph.COPIED_FIELDS),
                       *graph._tensors(g.extra), *g.produced(g.out)]
            ptrs |= {t.untyped_storage().data_ptr() for t in tensors}
        return ptrs

    def __call__(self, params, token, tkv, extra):
        got = self.graphed(params, token, tkv, extra)
        want = self.eager(params, token, tkv, extra)
        assert_same_step(got, want, f"step {self.steps}")
        static = self.static_storage()
        logits, new, new_extra, tel = got
        handed = [logits, *tel.values(), *graph._tensors(new_extra),
                  *(getattr(new, f) for f in graph.COPIED_FIELDS)]
        assert not {t.untyped_storage().data_ptr() for t in handed} & static
        self.steps += 1
        return got


def assert_same_step(got, want, what):
    (lg, tg, eg, hg), (lw, tw, ew, hw) = got, want
    assert torch.equal(lg, lw), what
    assert hg.keys() == hw.keys()
    for k in hw:
        assert torch.equal(hg[k], hw[k]), (what, k)
    for f in dataclasses.fields(TieredKVState):
        a, b = getattr(tg, f.name), getattr(tw, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), (what, f.name)
    assert (eg is None) == (ew is None)
    for a, b in zip(graph._tensors(eg), graph._tensors(ew)):
        assert torch.equal(a, b), what


@pytest.fixture(scope="module")
def models():
    cfg = get_smoke("qwen1_5_4b")
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(PARAM_KEY))
    tm = Model(port_smoke("qwen1_5_4b"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, tm, tp


def _port_engine(models):
    _, _, _, tm, tp = models
    te = TieredEngine(tm, tp, ts=TierScapeRunConfig(**RUN), device="cpu", **ENGINE)
    te._step_fn = CheckedStep(te._step_fn)
    return te


def _edit_tables(eng) -> int:
    """A table edit by hand: the first warm pages to the cold tier."""
    cache = eng.cache
    rids = np.where((cache.physical == WARM) & cache._page_exists)[0][:6]
    return cache.migrate_batch(rids, np.full(rids.size, COLD, np.int64))


@pytest.fixture(scope="module")
def lockstep(models):
    cfg, jm, jp, _, _ = models
    je = JEngine(jm, jp, ts=JRunConfig(**RUN), **ENGINE)
    te = _port_engine(models)
    rng = np.random.default_rng(PROMPT_SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (40, 40)]
    jreqs = [je.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    treqs = [te.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    je._fill_slots()
    te._fill_slots()
    windows, events, parked = [], {}, None
    while any(r is not None for r in je.slots) or parked is not None:
        assert je.stats.steps < 100
        steps = je.stats.steps
        if steps == PREEMPT_AT and parked is None and "preempt" not in events:
            parked = (je.preempt_slot(0), te.preempt_slot(0))
            events["preempt"] = steps
        elif parked is not None and steps == events["preempt"] + RESUME_AFTER:
            je.resume_into(0, parked[0])
            te.resume_into(0, parked[1])
            parked = None
            events["resume"] = steps
        if steps == EDIT_AT:
            events["edit"] = (_edit_tables(je), _edit_tables(te))
        je.step()
        te.step()
        if te.stats.windows > len(windows):
            windows.append((je.cache.physical.copy(), te.cache.physical.copy(),
                            je.cache.manager.placement.copy(),
                            te.cache.manager.placement.copy()))
    return dict(je=je, te=te, jreqs=jreqs, treqs=treqs, windows=windows, events=events,
                jstats=je.finish(), tstats=te.finish())


def test_captured_plumbing_matches_eager_and_reference(lockstep):
    ls = lockstep
    te, step = ls["te"], ls["te"]._step_fn
    assert [r.out_tokens for r in ls["treqs"]] == [r.out_tokens for r in ls["jreqs"]]
    assert all(len(r.out_tokens) == NEW_TOKENS and r.done for r in ls["treqs"])
    assert len(ls["windows"]) == ls["jstats"].windows >= 3
    for i, (jphys, tphys, jplace, tplace) in enumerate(ls["windows"]):
        np.testing.assert_array_equal(tphys, jphys, err_msg=f"window {i + 1}")
        np.testing.assert_array_equal(tplace, jplace, err_msg=f"window {i + 1}")
    for f in ("steps", "windows", "migrations", "completed", "attn_launches", "preemptions",
              "resumes", "resumed_pages"):
        assert getattr(ls["tstats"], f) == getattr(ls["jstats"], f), f
    assert ls["tstats"].migrations > 0 and ls["tstats"].resumed_pages > 0
    jmoved, tmoved = ls["events"]["edit"]
    assert tmoved == jmoved > 0
    assert te.cache.kernel_dispatches > 0
    # One capture; every later step replayed and was byte-equal to eager.
    assert step.graphed.captures == {"fused": 1}
    assert step.steps == ls["tstats"].steps == step.graphed.replays + 1


def test_route_change_and_moved_buffer_capture_again(models):
    cfg = models[0]
    te = _port_engine(models)
    rng = np.random.default_rng(PROMPT_SEED)
    for n in (40, 27):
        te.submit(rng.integers(1, cfg.vocab_size, n), max_new_tokens=NEW_TOKENS)
    te._fill_slots()
    g = te._step_fn.graphed
    for _ in range(2):
        te.step()
    try:
        ops.use_fused(False)
        for _ in range(2):
            te.step()
    finally:
        ops.use_fused(True)
    te.step()
    assert g.captures == {"fused": 1, "per_pool": 1} and g.replays == 3
    # A class buffer replaced (not edited in place): never replayed stale.
    st = te.cache.state
    te.cache.state = dataclasses.replace(st, c8_k=st.c8_k.clone())
    te.step()
    assert g.captures == {"fused": 2, "per_pool": 1} and g.replays == 3
    te.step()
    assert g.replays == 4
    # A new parameter tensor is a moved operand too.
    te.params = dict(te.params, final_norm=te.params["final_norm"].clone())
    te.step()
    assert g.captures["fused"] == 3


def test_launch_accounting_of_capture_and_replay():
    before = build.launch_counts()
    with build.recording_launches() as held:
        build.count_launch("fused_tiered_attention")
        build.count_launch("fused_tiered_attention")
        build.count_launch("paged_quant_attention")
    assert build.launch_counts() == before  # a capture runs nothing
    assert held["fused_tiered_attention"] == 2 and held["paged_quant_attention"] == 1
    build.count_replay({k: n for k, n in held.items() if n})
    build.count_replay({k: n for k, n in held.items() if n})
    after = build.launch_counts()
    assert after["fused_tiered_attention"] == before["fused_tiered_attention"] + 4
    assert after["paged_quant_attention"] == before["paged_quant_attention"] + 2
    build.count_launch("quant_pages")
    assert build.launch_counts()["quant_pages"] == before["quant_pages"] + 1


@pytest.mark.parametrize("pool", ["warm", "cold", "host"])
def test_table_commit_checks_class_rows(models, pool):
    """The class-bounds check moved from every decode layer to the table
    commit: a valid entry outside its class buffer (or the host summary)
    raises ``IndexError``; a stale entry past the count does not."""
    te = TieredEngine(models[3], models[4], ts=TierScapeRunConfig(**RUN), device="cpu",
                      **ENGINE)
    cache = te.cache
    rows = {"warm": cache.state.c8_k.shape[1], "cold": cache.state.c4_k.shape[1],
            "host": cache.state.host_summary.shape[1]}[pool]
    ed = cache._tables
    ed.tables[pool][0, 1, 3] = rows  # past the count: stale, exempt
    cache.state = ed.commit(cache.state)
    ed.insert(pool, [cache.rid(0, 1, 0)], [rows - 1])
    cache.state = ed.commit(cache.state)
    rid = cache.rid(1, 0, 0)
    ed.insert(pool, [rid], [rows])
    with pytest.raises(IndexError, match="outside the"):
        ed.commit(cache.state)
    ed.remove(pool, [rid], [rows])  # a failed commit keeps its edits on the host
    ed.insert(pool, [rid], [-1])
    with pytest.raises(IndexError, match="outside the"):
        ed.commit(cache.state)


def test_captured_plumbing_carries_the_hybrid_state():
    """The zamba2 SMOKE: the SSM side state is copied in and handed back
    fresh each step, and a resume's in-place write of a slot's rows into the
    engine's side state reaches the next replay. Byte-equal to the eager
    step at every step, and the tokens equal an engine on the eager step."""
    model = Model(port_smoke("zamba2_1_2b"), device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(PROMPT_SEED)
    prompts = [rng.integers(1, model.cfg.vocab_size, n) for n in (24, 19)]
    tokens = {}
    for name in ("eager", "captured"):
        eng = TieredEngine(model, params, ts=TierScapeRunConfig(**RUN), device="cpu", **ENGINE)
        if name == "captured":
            eng._step_fn = CheckedStep(eng._step_fn)
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        eng._fill_slots()
        for i in range(12):
            if i == 3:
                pre = eng.preempt_slot(1)
            if i == 5:
                eng.resume_into(1, pre)
            eng.step()
        tokens[name] = [r.out_tokens for r in reqs]
        assert all(r.done for r in reqs)
    assert tokens["captured"] == tokens["eager"]
    assert eng._step_fn.graphed.captures == {"fused": 1}
    assert eng._step_fn.steps == 12
