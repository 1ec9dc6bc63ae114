"""The port's in-program tracer (``repro_torch.tracing``) inside the serving
engine, its cache and the media pipeline, on the CPU.

One ``qwen1_5_4b`` SMOKE engine serves three requests over two slots
through six tier windows, async with prefetch. From the third window on,
every live host page's recorded hotness is raised, so that prefetch stages
host pages mid-window and a boundary plan claims some of them; in the fourth
window the staging ring refuses one demand cohort its credits once, as under
backpressure, so one busy tick stalls. Spans must
nest as the engine calls them, each child inside its parent; the four
``EngineStats`` clocks must be the sums of their spans; the records of a
range of steps must sum to the deltas of the clocks and counters over those
steps; every table commit must leave one ``cache.table_uploads`` record; and
the live prefetch and launch counts must read the pipeline and the cache.
Under ``torch.profiler`` every span must appear as a
``repro_torch.*`` user annotation, and tokens, placements and pipeline
counters must equal the run without a profiler, which enters no
``record_function`` at all.
"""

import collections
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import TierScapeRunConfig, get_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving.engine import CLOCKS, TieredEngine  # noqa: E402
from repro_torch.serving.kv_cache import HOST4, HOST8  # noqa: E402

ENGINE = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
RUN = dict(enabled=True, policy="analytical", alpha=0.1, window_steps=6)
PROMPTS, NEW_TOKENS, BOOST, BOOST_FROM = (40, 27, 33), 20, 500.0, 2
COUNTERS = ("busy_ticks", "stall_ticks", "prefetch_hits", "prefetch_misses")

# Where each span opens (None: outside any span).
PARENTS = {
    "engine.step": {None},
    "engine.prefill": {None},
    "engine.finish": {None},
    "engine.decode": {"engine.step"},
    "engine.decode.wait": {"engine.decode"},
    "cache.fold_telemetry": {"engine.step"},
    "cache.prefetch_tick": {"engine.step"},
    "pipeline.tick": {"engine.step", "cache.prefetch_tick", "pipeline.drain"},
    "pipeline.stage": {"pipeline.tick"},
    "pipeline.transcode": {"pipeline.tick"},
    "pipeline.commit": {"pipeline.tick"},
    "pipeline.drain": {"cache.drain", "engine.release", "engine.finish"},
    "engine.page_out": {"engine.step"},
    "engine.release": {"engine.step"},
    "engine.window": {"engine.step"},
    "cache.drain": {"engine.window"},
    "cache.policy": {"engine.window"},
    "cache.submit": {"engine.window"},
    "pipeline.busy_ticks": {"pipeline.tick"},
    "pipeline.stall_ticks": {"pipeline.tick"},
    "prefetch.hits": {"cache.submit"},
    "prefetch.misses": {"cache.submit"},
    "cache.table_uploads": {"engine.prefill", "engine.page_out", "pipeline.stage",
                            "pipeline.commit"},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The runs are small: more threads only contend with other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke("qwen1_5_4b")
    m = Model(cfg, device="cpu")
    return cfg, m, m.init(0)


def serve(model, profile=False, trace_path=None):
    """The steered run; per loop turn the stats before it, per step the
    placements after it."""
    cfg, m, params = model
    eng = TieredEngine(m, params, ts=TierScapeRunConfig(**RUN), device="cpu", **ENGINE)
    cache = eng.cache
    record = cache.manager.record_access_counts

    def steer(counts):
        if eng.stats.windows >= BOOST_FROM:
            host = ((cache.physical == HOST8) | (cache.physical == HOST4)) & cache._page_exists
            counts = counts + BOOST * host
        record(counts)

    cache.manager.record_access_counts = steer
    page_outs = []
    append = cache.append_pages

    def tap(*args):
        page_outs.append(eng.tracer._open)
        return append(*args)

    cache.append_pages = tap
    commits = []
    commit = cache._tables.commit

    def upload(state):
        commits.append(eng.tracer._open)
        return commit(state)

    cache._tables.commit = upload
    acquire = cache.staging_ring.try_acquire
    refused = []

    def credits(n, speculative=False):
        if not speculative and not refused and eng.stats.windows >= 3:
            refused.append(n)
            return None
        return acquire(n, speculative)

    cache.staging_ring.try_acquire = credits
    rng = np.random.default_rng(1)
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size, n), max_new_tokens=NEW_TOKENS)
            for n in PROMPTS]
    snaps, placements = {}, []
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        prof.__enter__()
    try:
        while any(s is not None for s in eng.slots) or eng.queue:
            snaps[eng.stats.steps] = clocks_and_counters(eng)
            eng._fill_slots()
            eng.step()
            placements.append((cache.physical.copy(), cache.manager.placement.copy()))
        stats = eng.finish()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    snaps[stats.steps + 1] = clocks_and_counters(eng)
    return types.SimpleNamespace(eng=eng, stats=stats, reqs=reqs, snaps=snaps,
                                 placements=placements, page_outs=page_outs, commits=commits,
                                 records=eng.tracer.records(0, stats.steps + 1))


def clocks_and_counters(eng):
    p = eng.cache.pipeline
    return ({k: getattr(eng.stats, k) for k in CLOCKS},
            {k: getattr(p, k) for k in COUNTERS})


@pytest.fixture(scope="module")
def run(model):
    calls = []

    def no_record_function(name, *a):
        calls.append(name)
        raise AssertionError(f"record_function({name!r}) with no profiler active")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", no_record_function)
        out = serve(model)
    assert calls == []
    return out


def spans(records):
    return [r for r in records if r[3] is not None]


def test_spans_nest_as_the_engine_calls_them(run):
    st, recs = run.stats, run.records
    assert st.windows >= 3 and st.migrations > 0
    assert st.prefetch_hits > 0 and st.prefetch_misses > 0 and run.eng.cache.pipeline.stall_ticks > 0
    assert "engine.page_out" in run.page_outs  # page-outs ran inside their span
    names = collections.Counter(r[0] for r in recs)
    assert set(names) == set(PARENTS), set(names) ^ set(PARENTS)
    assert names["engine.step"] == st.steps and names["engine.window"] == st.windows
    assert names["engine.prefill"] == len(PROMPTS)
    by_key = collections.defaultdict(list)
    for r in spans(recs):
        by_key[(r[1], r[0])].append(r)
    for name, step, parent, t0, t1 in recs:
        assert parent in PARENTS[name], (name, parent)
        if t0 is not None:
            assert t0 <= t1
        if parent is None:
            continue
        lo, hi = (t0, t1) if t0 is not None else (None, None)
        outer = [p for p in by_key[(step, parent)]
                 if lo is None or (p[3] <= lo and hi <= p[4])]
        assert outer, f"{name} at step {step} lies in no {parent} of that step"
    # Counters tally the pipeline's own counts.
    p = run.eng.cache.pipeline
    for key, attr in (("pipeline.busy_ticks", "busy_ticks"),
                      ("pipeline.stall_ticks", "stall_ticks"),
                      ("prefetch.hits", "prefetch_hits"), ("prefetch.misses", "prefetch_misses")):
        assert sum(r[4] for r in recs if r[0] == key) == getattr(p, attr), key
    # One upload record per table commit, inside the span that committed.
    assert [r[2] for r in recs if r[0] == "cache.table_uploads"] == run.commits


def test_clocks_are_the_sums_of_their_spans(run):
    for clock, keys in CLOCKS.items():
        ns = sum(r[4] - r[3] for r in spans(run.records) if (r[2], r[0]) in keys)
        assert getattr(run.stats, clock) == ns * 1e-9, clock
    assert run.stats.daemon_s > run.stats.window_s > 0
    assert run.stats.decode_s > 0 and run.stats.prefill_s > 0


def test_step_records_sum_to_the_stats_deltas(run):
    steps = sorted(run.snaps)
    tracer = run.eng.tracer
    for a, b in [(steps[0], steps[-1]), (3, 9), (6, 25), (12, 13), (25, steps[-2])]:
        recs = tracer.records(a, b)
        (ca, na), (cb, nb) = run.snaps[a], run.snaps[b]
        for clock, keys in CLOCKS.items():
            ns = sum(r[4] - r[3] for r in spans(recs) if (r[2], r[0]) in keys)
            assert ns * 1e-9 == pytest.approx(cb[clock] - ca[clock], rel=1e-9, abs=1e-12), clock
        for key, attr in (("pipeline.busy_ticks", "busy_ticks"),
                          ("pipeline.stall_ticks", "stall_ticks"),
                          ("prefetch.hits", "prefetch_hits"),
                          ("prefetch.misses", "prefetch_misses")):
            assert sum(r[4] for r in recs if r[0] == key) == nb[attr] - na[attr], key


def test_stats_read_the_live_counters(run):
    eng = run.eng
    p = eng.cache.pipeline
    assert (eng.stats.prefetch_staged, eng.stats.prefetch_hits, eng.stats.prefetch_misses) == (
        p.prefetch_staged, p.prefetch_hits, p.prefetch_misses)
    assert eng.stats.attn_launches == eng.cache.attn_launches == eng.la * eng.stats.steps
    # Live before ``finish`` too: the first snapshot past a claim shows it.
    hits = [n["prefetch_hits"] for _, n in (run.snaps[s] for s in sorted(run.snaps))]
    assert hits[0] == 0 and max(hits) == p.prefetch_hits


def test_the_ring_drops_whole_steps_only():
    tr = tracing.Tracer(capacity=8)
    for step in range(6):
        tr.step = step
        with tr.span("engine.step"):
            with tr.span("engine.decode"):
                pass
        tr.count("pipeline.busy_ticks")
    # 18 records in a ring of 8: steps 0-2 are gone, step 3 in part.
    assert tr.records(0, 6) is None and tr.records(3, 6) is None
    got = tr.records(4, 6)
    assert [(r[0], r[1]) for r in got] == [
        (n, s) for s in (4, 5) for n in ("engine.decode", "engine.step", "pipeline.busy_ticks")]
    assert tr.seconds([("engine.step", "engine.decode")]) >= 0
    with pytest.raises(ValueError):
        tracing.Tracer(capacity=12)


def test_profiler_sees_every_span_and_changes_nothing(model, run, tmp_path):
    path = tmp_path / "trace.json"
    prof = serve(model, profile=True, trace_path=path)
    assert [r.out_tokens for r in prof.reqs] == [r.out_tokens for r in run.reqs]
    assert len(prof.placements) == len(run.placements)
    for (pp, pd), (rp, rd) in zip(prof.placements, run.placements):
        np.testing.assert_array_equal(pp, rp)
        np.testing.assert_array_equal(pd, rd)
    a, b = prof.eng.cache.pipeline, run.eng.cache.pipeline
    for f in COUNTERS + ("prefetch_staged", "cohorts_done", "pages_moved"):
        assert getattr(a, f) == getattr(b, f), f
    assert prof.stats.migrations == run.stats.migrations
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    seen = collections.Counter(
        e["name"][len(tracing.PROFILER_PREFIX):] for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and e.get("name", "").startswith(tracing.PROFILER_PREFIX))
    assert seen == collections.Counter(r[0] for r in spans(prof.records))
