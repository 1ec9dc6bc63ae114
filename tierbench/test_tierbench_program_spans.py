"""The readers of the program's spans and counters (``program_spans`` and
the twelve metrics on it) over a short CPU run of a ``qwen1_5_4b`` SMOKE
engine: the loop of ``harness.Driver`` in small, each step inside a
``tierbench.step`` span, the last steps profiled as the traced slice.

Each reader returns a number over the window and None where it has nothing
to read: no tracer in the program (as at a commit without one), no device
events (the CPU), no staged page meeting a boundary. The daemon's two
readers add up to ``daemon_ms_per_step``; the step-span alignment puts every
program span inside its profiler copy to within 200 us; and the slice's idle time
by innermost span equals a brute-force count on made-up device intervals.
"""

import collections
import json
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs import TierScapeRunConfig, get_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving.engine import TieredEngine  # noqa: E402
from tierbench import harness, program_spans, trace  # noqa: E402
from tierbench.metrics import daemon_ms_per_step, window_ms  # noqa: E402

NEW = ("step_self_ms", "decode_wait_ms", "telemetry_fold_ms_per_step", "media_tick_ms_per_step",
       "page_out_ms_per_step", "release_ms_per_step", "boundary_drain_ms", "boundary_policy_ms",
       "boundary_submit_ms", "pipeline_stall_pct", "prefetch_hit_pct", "idle_in_program_pct")
ENGINE = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
RUN = dict(enabled=True, policy="analytical", alpha=0.1, window_steps=6)
PROMPTS, NEW_TOKENS, WINDOW, SLICE_STEPS = (40, 27, 33, 36), 20, (2, 32), 8


def reader(name):
    return __import__(f"tierbench.metrics.{name}", fromlist=["read"]).read


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_smoke("qwen1_5_4b")
        model = Model(cfg, device="cpu")
        eng = TieredEngine(model, model.init(0), ts=TierScapeRunConfig(**RUN), device="cpu",
                           **ENGINE)
        rng = np.random.default_rng(1)
        pending = [eng.make_request(rng.integers(1, cfg.vocab_size, n), NEW_TOKENS)
                   for n in PROMPTS]
        stats = {}

        def turn():
            for i in range(eng.bs):
                if eng.slots[i] is None and pending:
                    with torch.profiler.record_function("tierbench.start_request"):
                        eng.start_request(i, pending.pop(0))
            stats[eng.stats.steps] = harness.engine_stats(eng)
            with torch.profiler.record_function("tierbench.step"):
                eng.step()

        while eng.stats.steps < WINDOW[1]:
            turn()
        first = eng.stats.steps
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.SLICE):
                for _ in range(SLICE_STEPS):
                    turn()
        path = tmp_path_factory.mktemp("slice") / "trace.json"
        prof.export_chrome_trace(str(path))
    finally:
        torch.set_num_threads(n_threads)
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    res = types.SimpleNamespace(window_steps=WINDOW, stats_open=stats[WINDOW[0]],
                                stats_close=stats[WINDOW[1]], slice_steps=(first, eng.stats.steps),
                                trace=trace.read(str(path)))
    return types.SimpleNamespace(eng=eng, res=res, events=events)


def test_each_reader_reads_the_window(run):
    res = run.res
    got = {name: reader(name)(res) for name in NEW}
    # The CPU has no device events: the idle share finds nothing to read.
    assert got.pop("idle_in_program_pct") is None
    for name, v in got.items():
        assert isinstance(v, float) and v >= 0, name
    assert got["telemetry_fold_ms_per_step"] > 0 and got["media_tick_ms_per_step"] > 0
    assert got["boundary_policy_ms"] > 0 and got["boundary_submit_ms"] > 0
    # The daemon is the fold and the ticks; the boundary holds its three parts.
    daemon = got["telemetry_fold_ms_per_step"] + got["media_tick_ms_per_step"]
    assert daemon == pytest.approx(daemon_ms_per_step.read(res), rel=1e-9)
    parts = got["boundary_drain_ms"] + got["boundary_policy_ms"] + got["boundary_submit_ms"]
    assert 0 < parts <= window_ms.read(res)


def test_readers_find_nothing_to_read(run, monkeypatch):
    res = run.res
    between = types.SimpleNamespace(**vars(res))
    recs = program_spans.records(res)
    bounds = sorted(r[1] for r in recs if r[0] == program_spans.WINDOW)
    between.window_steps = (bounds[0] + 1, bounds[1])  # no boundary in it
    assert reader("prefetch_hit_pct")(between) is None
    assert reader("boundary_submit_ms")(between) is None
    monkeypatch.setattr(tracing, "_current", None)
    assert all(reader(name)(res) is None for name in NEW)
    monkeypatch.undo()
    # A program without the tracer module.
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert all(reader(name)(res) is None for name in NEW)


def test_alignment_puts_spans_on_their_profiler_copies(run):
    aligned = program_spans.aligned_spans(run.res)
    mine = collections.defaultdict(list)
    for a, b, name in sorted(aligned):
        mine[name].append((a, b))
    theirs = collections.defaultdict(list)
    for e in run.events:
        name = e.get("name", "")
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and \
                name.startswith(tracing.PROFILER_PREFIX):
            a = float(e["ts"]) * 1e-6
            theirs[name[len(tracing.PROFILER_PREFIX):]].append((a, a + float(e["dur"]) * 1e-6))
    # Prefills of the slice's first turn ran before its first step: keyed
    # to it, they are aligned too.
    assert set(mine) == set(theirs) and "engine.step" in mine
    # A copy opens before its span's first clock reading and closes after
    # its last, so each aligned span lies inside its copy; a collection or a
    # descheduled thread between the two readings only widens the copy.
    tol, ends = 200e-6, []
    for name, spans in mine.items():
        copies = sorted(theirs[name])
        assert len(copies) == len(spans), name
        for (a, b), (pa, pb) in zip(spans, copies):
            assert pa - tol <= a and b <= pb + tol, (name, a - pa, b - pb)
            ends += [abs(a - pa), abs(b - pb)]
    assert np.median(ends) < tol


def brute_force_idle(spans, gaps):
    """Idle seconds by innermost span, one elementary segment at a time."""
    edges = sorted({x for a, b, _ in spans for x in (a, b)} | {x for g in gaps for x in g})
    out = collections.Counter()
    for a, b in zip(edges, edges[1:]):
        mid = 0.5 * (a + b)
        if not any(g0 <= mid <= g1 for g0, g1 in gaps):
            continue
        open_ = [s for s in spans if s[0] <= mid <= s[1]]
        name = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else program_spans.OUTSIDE
        out[name] += b - a
    return out


def test_idle_time_by_innermost_span(run):
    res = run.res
    aligned = program_spans.aligned_spans(res)
    # Made-up device work: busy through each decode wait and each page-out.
    busy = sorted((a, b, "kernel") for a, b, name in aligned
                  if name in ("engine.decode.wait", "engine.page_out"))
    res = types.SimpleNamespace(**vars(res))
    res.trace = trace.Trace(window=run.res.trace.window, device=busy, spans=run.res.trace.spans)
    got = program_spans.idle_by_span(res)
    lo, hi = res.trace.window
    edges = [lo] + [x for iv in res.trace._union() for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)]
    want = brute_force_idle(aligned, gaps)
    assert set(got) - {program_spans.OUTSIDE} == set(want) - {program_spans.OUTSIDE}
    for name, v in want.items():
        assert got[name] == pytest.approx(v, rel=1e-6, abs=1e-9), name
    assert "engine.decode.wait" not in got and got["cache.fold_telemetry"] > 0
    named = sum(v for k, v in want.items()
                if k not in (program_spans.STEP, program_spans.OUTSIDE))
    assert reader("idle_in_program_pct")(res) == pytest.approx(
        100.0 * named / sum(want.values()), rel=1e-6)
