"""One run of one cell: set-up, the open-loop window, the traced slice and
the correctness check.

Everything that belongs to a cell is found by name: the workload entry of
``BENCHMARK.json`` names a configuration (``configs/<config>.json``, its
family module ``families/<family>.py`` and its plain
reference ``references/<reference>.py``) and a traffic mix
(``mixes/<traffic>.json``); ``cells/<workload>.json`` holds the engine
geometry, the offered rate and the check's limits; each per-layer metric is
``metrics/<name>.py``. The harness reaches the model's shape only through
the family module.

The loop drives ``repro_torch.serving.engine.TieredEngine`` through its
public calls: ``start_request`` into each free slot, FIFO from the harness's
queue; ``step`` while any slot is active; otherwise a wait until the next
arrival is due. Requests are timed from when they were due.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import math
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from tierbench import counts, families, peaks, tco, traffic, weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = ROOT / "build" / "tierbench"
# Placement levels of the program's cache (``TieredKVCache.physical``).
WARM, COLD, HOST8, HOST4, INFLIGHT = 1, 2, 3, 4, -1
SCHEDULE_TAIL_S = 20.0


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict
    conf: Dict  # the configuration file
    mix: Dict
    cell: Dict  # cells/<name>.json
    manifest: Dict


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    manifest = load_json(root / "BENCHMARK.json")
    wl = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cfg = next(c for c in manifest["configs"] if c["name"] == wl["config"])
    return Cell(name=workload, workload=wl, conf=load_json(root / cfg["file"]),
                mix=load_json(HERE / "mixes" / f"{wl['traffic']}.json"),
                cell=load_json(HERE / "cells" / f"{workload}.json"), manifest=manifest)


# ----------------------------------------------------------- the program
def build_engine(conf: Dict, cell: Dict, params, device):
    """The program under test, built from the configuration file: the
    model, the tiering settings and the engine geometry."""
    from repro_torch.configs.base import TierScapeRunConfig
    from repro_torch.models import Model
    from repro_torch.serving.engine import TieredEngine

    mc = families.of(conf).model_config(conf)
    t = conf["tiering"]
    ts = TierScapeRunConfig(enabled=True, policy=t["policy"], alpha=float(t["alpha"]),
                            window_steps=int(t["window_steps"]),
                            kv_page_tokens=int(t["page_tokens"]),
                            async_migration=bool(t["async_migration"]),
                            prefetch=bool(t["prefetch"]), warm_bits=int(t["warm_bits"]),
                            cold_bits=int(t["cold_bits"]),
                            host_media_device=t["host_media_device"], faults=False)
    return TieredEngine(Model(mc, device=device), params, batch_slots=int(cell["batch_slots"]),
                        page_tokens=int(t["page_tokens"]), max_seq_len=int(cell["max_seq_len"]),
                        recent_window=int(t["recent_window"]), ts=ts, device=device)


def page_costs(conf: Dict) -> np.ndarray:
    """USD of one page in placement levels 0..4 (``tco.level_costs``)."""
    m = families.of(conf).shape(conf)
    t = conf["tiering"]
    return tco.level_costs(int(t["page_tokens"]) * m.kv * m.hd * 2, int(t["warm_bits"]),
                           int(t["cold_bits"]))


STAT_FIELDS = ("steps", "windows", "completed", "overlapped_steps", "decode_s", "daemon_s",
               "prefill_s", "window_s")


def engine_stats(eng) -> Dict[str, float]:
    return {k: float(getattr(eng.stats, k)) for k in STAT_FIELDS}


# ------------------------------------------------------------- the loop
@dataclasses.dataclass
class Rec:
    arrival: traffic.Arrival
    req: Any
    slot: int
    g0: int  # engine steps before its first decode step
    times: List[float]  # wall time of each token (the first ends the prefill)
    t_done: Optional[float] = None


class Driver:
    """The open-loop loop over one engine, with what the metrics and the
    check read: per request its token times, per engine step the cache's
    placement levels, the page masses the program recorded as its hotness
    telemetry (``record_hot``) and the active slots, per tier-window
    boundary the placement's cost."""

    def __init__(self, eng, arrivals: List[traffic.Arrival], t0: float, level_costs,
                 span: Callable = None, clock: Callable = time.perf_counter,
                 sleep: Callable = time.sleep, record_hot: bool = True):
        self.eng = eng
        c = eng.cache
        self.shape = (c.la, c.bs, c.max_pages)  # placement levels [layers, slots, pages]
        self.clock, self.sleep = clock, sleep
        self.arrivals = arrivals
        self.t0 = t0
        self.costs = level_costs
        self.span = span
        self.base = eng.stats.steps
        self.snaps: List[np.ndarray] = []  # placement levels before each step
        self.hot: List[np.ndarray] = []  # page masses x 1000 recorded at each step
        if record_hot:
            mgr = eng.cache.manager
            record = mgr.record_access_counts

            def tap(counts):
                self.hot.append(np.asarray(counts, np.float32))
                record(counts)

            mgr.record_access_counts = tap
        self.step_slots: List[tuple] = []  # (slots, total lengths, rec ids) per step
        self.recs: List[Rec] = []
        self.boundaries: List[tuple] = []  # (time, cost, cost at level 0)
        self.live: List[Optional[Rec]] = [None] * eng.bs
        self.queue: deque = deque()
        self.next = 0
        self.late_s = 0.0  # the most an idle wait overslept a due arrival

    def _span(self, name):
        return self.span(name) if self.span else contextlib.nullcontext()

    def snapshot(self) -> None:
        self.snaps.append(self.eng.cache.physical.astype(np.int8))

    def run(self, stop_at: float, max_steps: Optional[int] = None,
            on_step: Callable = None) -> None:
        eng, clock = self.eng, self.clock
        steps = 0
        while True:
            now = clock()
            if now >= stop_at or (max_steps is not None and steps >= max_steps):
                return
            while self.next < len(self.arrivals) and \
                    self.t0 + self.arrivals[self.next].due <= now:
                self.queue.append(self.arrivals[self.next])
                self.next += 1
            for i in range(eng.bs):
                if self.live[i] is None and self.queue:
                    a = self.queue.popleft()
                    req = eng.make_request(a.prompt, a.max_new_tokens)
                    g0 = eng.stats.steps
                    with self._span("tierbench.start_request"):
                        eng.start_request(i, req)
                    rec = Rec(a, req, i, g0, [clock()])
                    self.live[i] = rec
                    self.recs.append(rec)
            active = [r for r in self.live if r is not None]
            if not active:
                due = (self.t0 + self.arrivals[self.next].due
                       if self.next < len(self.arrivals) else stop_at)
                with self._span("tierbench.wait"):
                    self.sleep(max(min(due, stop_at) - clock(), 0.0))
                self.late_s = max(self.late_s, clock() - min(due, stop_at))
                continue
            self.snapshot()
            self.step_slots.append((
                np.array([r.slot for r in active]),
                np.array([len(r.arrival.prompt) + len(r.times) - 1 for r in active]),
                tuple(active)))
            windows = eng.stats.windows
            with self._span("tierbench.step"):
                eng.step()
            t = clock()
            steps += 1
            for r in active:
                r.times.append(t)
                if r.req.done:
                    r.t_done = t
                    self.live[r.slot] = None
            if eng.stats.windows != windows:
                self.boundaries.append((t, *tco.placement_cost(self.resident(), self.costs)))
            if on_step:
                on_step()

    def resident(self) -> np.ndarray:
        """Level of every existing page: where it lies, or for a page in
        flight where the plan sends it (the policy's DRAM choice lands warm)."""
        c = self.eng.cache
        phys = c.physical
        lv = phys[phys != 0].copy()
        infl = lv == INFLIGHT
        plan = c.manager.placement[phys != 0][infl]
        lv[infl] = np.where(plan == 0, WARM, plan)
        return lv

    def levels_at(self, step: int) -> np.ndarray:
        """Placement levels [layers, slots, pages] before engine step ``step``."""
        return self.snaps[step - self.base].reshape(self.shape)

    def hot_at(self, step: int) -> np.ndarray:
        """Each page's share of engine step ``step``'s attention as the
        program recorded it [layers, slots, pages]."""
        return self.hot[step - self.base].reshape(self.shape) / 1000.0

    def backlog(self, at: float) -> int:
        """Requests due by ``at`` (a reading of the clock) and not started."""
        due = sum(1 for a in self.arrivals if self.t0 + a.due <= at)
        return due - sum(1 for r in self.recs if r.times[0] <= at)


# ------------------------------------------------------------ warm-up
def warm_up(eng, mix: Dict, conf: Dict, seed: int) -> None:
    """Every shape the traffic uses, before the clock starts: prefills at
    the mix's shortest, median and longest prompt, decode steps (the
    step's capture), page-outs and two tier-window boundaries with their
    migrations, then the requests finish and free their slots."""
    rng = np.random.default_rng([seed, 1])
    spec = mix["prompt_tokens"]
    median = int(traffic.length_quantiles(spec, 1)[0])
    lens = [spec.get("min", median), median, spec.get("max", median)]
    new = 2 * int(conf["tiering"]["window_steps"]) + 2
    vocab = conf["vocab_size"]
    pending = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    while pending or any(s is not None for s in eng.slots):
        for i in range(eng.bs):
            if eng.slots[i] is None and pending:
                eng.start_request(i, eng.make_request(pending.pop(0), new))
        if any(s is not None for s in eng.slots):
            eng.step()
    eng.cache.drain_migrations()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------- metrics
def percentile(values, q: float) -> Optional[float]:
    """The q-th percentile (linear interpolation) over every sample."""
    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else None


def end_to_end(drv: Driver, ws: float, we: float) -> Dict[str, Optional[float]]:
    ttft, gaps = [], []
    by_idx = {r.arrival.idx: r for r in drv.recs}
    for a in drv.arrivals:
        due = drv.t0 + a.due
        if not ws <= due < we:
            continue
        r = by_idx.get(a.idx)
        first = r.times[0] if r is not None else math.inf
        ttft.append(min(first, we) - due)
    for r in drv.recs:
        t = r.times
        gaps += [t[k] - t[k - 1] for k in range(1, len(t)) if ws <= t[k] < we]
    tokens = sum(1 for r in drv.recs for t in r.times if ws <= t < we)
    b = [(c, m) for t, c, m in drv.boundaries if ws <= t < we]
    tco_pct = tco.savings_pct(sum(c for c, _ in b), sum(m for _, m in b)) if b else None
    return {
        "tokens_per_s": tokens / (we - ws) if tokens else None,
        "ttft_p95_ms": None if not ttft else percentile(ttft, 95) * 1e3,
        "tpot_p95_ms": None if not gaps else percentile(gaps, 95) * 1e3,
        "tco_savings_pct": tco_pct,
        "_attempted": len(ttft),
        "_tokens_in_window": len(gaps),
        "_boundaries": len(b),
    }


# ------------------------------------------------------------- checking
def cache_view(drv: Driver, rec: Rec, conf: Dict):
    """What the request's decode steps read of its cache: ``widths`` [n-1,
    layers, P] (the codec width each page holds) and ``read`` (on the
    device), P cut to the pages used.

    A width of 0 means the program holds no page there: the page has not
    left the recent window yet, or the program released it. A reference
    reads such a page from its own bf16 keys and values, and a reference of
    a windowed model masks it by its window, so a page released while still
    inside the window shows as a logit gap."""
    t = conf["tiering"]
    bits = {WARM: int(t["warm_bits"]), COLD: int(t["cold_bits"]), HOST8: 8, HOST4: 4}
    n = len(rec.req.out_tokens)
    if n <= 1:
        return None, None
    lv = np.stack([drv.levels_at(rec.g0 + j)[:, rec.slot] for j in range(n - 1)])
    widths = np.zeros(lv.shape, np.int64)
    prev = np.zeros(lv.shape[1:], np.int64)
    for j in range(n - 1):
        cur = np.zeros_like(prev)
        for lvl, b in bits.items():
            cur[lv[j] == lvl] = b
        # In flight: the width it had, or int8 when it was staged before it
        # was ever seen (paged out to the warm tier and staged in one call).
        infl = lv[j] == INFLIGHT
        cur[infl] = np.where(prev[infl] != 0, prev[infl], 8)
        widths[j] = cur
        prev = cur
    read = (lv == WARM) | (lv == COLD)
    used = int((widths != 0).any(axis=(0, 1)).nonzero()[0].max() + 1) if widths.any() else 0
    return widths[:, :, :used], read[:, :, :used]


def sample(drv: Driver, seed: int, min_tokens: int, done_by: float) -> List[Rec]:
    """Finished requests drawn from the seed: the longest, one from every
    batch slot that finished one, then more until they hold ``min_tokens``
    served tokens."""
    done = [r for r in drv.recs if r.t_done is not None and r.t_done <= done_by]
    if not done:
        return []
    done.sort(key=lambda r: r.arrival.idx)
    longest = max(done, key=lambda r: (len(r.arrival.prompt) + r.arrival.max_new_tokens,
                                       -r.arrival.idx))
    rng = np.random.default_rng([seed, 2])
    rest = [done[i] for i in rng.permutation(len(done)) if done[i] is not longest]
    out = [longest]
    for slot in sorted({r.slot for r in rest} - {longest.slot}):
        out.append(next(r for r in rest if r.slot == slot))
    chosen = {id(r) for r in out}
    tokens = sum(len(r.req.out_tokens) for r in out)
    for r in rest:
        if tokens >= min_tokens:
            break
        if id(r) not in chosen:
            out.append(r)
            tokens += len(r.req.out_tokens)
    return out


def reference_module(conf: Dict):
    return importlib.import_module(f"tierbench.references.{conf['reference']}")


def compare_sample(params, conf: Dict, drv: Driver, recs: List[Rec],
                   precision: str = "f32") -> List[Dict[str, Any]]:
    """Per sampled request, its readings against the plain reference: the
    gaps by which its served tokens' reference logits lie below the
    reference's best (``gap`` the widest, ``gap_sum``), and at each decode
    step and layer the L1 distance between the page masses the program
    recorded as its hotness telemetry and the reference's (``hot_max`` the
    widest, ``hot_sum`` over ``hot_rows``). With ``precision`` other than
    "f32" the same of the control (``c``-prefixed): the tokens it puts
    first, and its page masses."""
    ref = reference_module(conf)
    out = []
    for r in recs:
        served = np.asarray(r.req.out_tokens, np.int64)
        widths, read = cache_view(drv, r, conf)
        logits, hot = ref.served_logits(params, conf, r.arrival.prompt, served, widths, read)
        best = logits.max(dim=-1).values
        st = torch.as_tensor(served, device=logits.device)
        gap = best - logits.gather(1, st[:, None])[:, 0]
        row = {"tokens": len(served), "gap": float(gap.max()), "gap_sum": float(gap.sum())}
        prog = None
        if hot is not None:
            p = hot.shape[-1]
            prog = torch.as_tensor(np.stack([drv.hot_at(r.g0 + j)[:, r.slot, :p]
                                             for j in range(hot.shape[0])]), device=hot.device)
            row.update(_hot_distance(prog, hot))
        if precision != "f32":
            low, chot = ref.served_logits(params, conf, r.arrival.prompt, served, widths, read,
                                          precision=precision)
            cgap = best - logits.gather(1, low.argmax(dim=-1)[:, None])[:, 0]
            row.update(cgap=float(cgap.max()), cgap_sum=float(cgap.sum()))
            if hot is not None:
                row.update({f"c{k}": v for k, v in _hot_distance(chot, hot).items()})
            del low, chot
        out.append(row)
        del logits, hot, prog
    return out


def _hot_distance(hot: torch.Tensor, ref_hot: torch.Tensor) -> Dict[str, float]:
    """L1 distance per decode step and layer between two [steps, layers,
    pages] page-mass arrays: the widest, the sum and the rows."""
    d = (hot.to(torch.float32) - ref_hot).abs().sum(dim=-1)
    return {"hot_max": float(d.max()), "hot_sum": float(d.sum()), "hot_rows": int(d.numel())}


def numbers(rows: List[Dict[str, Any]], control: bool = False) -> Dict[str, float]:
    """The numbers compared, of the program or of the control: the widest
    logit gap, the mean gap over every sampled token, the widest page-mass
    distance and its mean over every decode step and layer."""
    c = "c" if control else ""
    tokens = sum(g["tokens"] for g in rows)
    hot_rows = sum(g.get("hot_rows", 0) for g in rows)
    return {
        "logit_gap": max((g[c + "gap"] for g in rows), default=math.inf),
        "mean_logit_gap": sum(g[c + "gap_sum"] for g in rows) / tokens if tokens else math.inf,
        "hotness_gap": max((g[c + "hot_max"] for g in rows if "hot_max" in g), default=math.inf),
        "mean_hotness_gap": (sum(g[c + "hot_sum"] for g in rows if "hot_sum" in g) / hot_rows
                             if hot_rows else math.inf),
        "_tokens": tokens,
    }


def check(values: Dict[str, float], limits: Dict, min_tokens: int) -> Dict[str, Dict[str, float]]:
    """Each number the cell sets a limit for, beside its limit, and the
    sampled tokens against their least count."""
    out = {k: {"value": values[k], "limit": float(limits[k])} for k in values if k in limits}
    out["sampled_tokens_at_least"] = {"value": float(values["_tokens"]),
                                      "limit": float(min_tokens)}
    return out


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    ok = all(c["value"] <= c["limit"] for k, c in checks.items() if k != "sampled_tokens_at_least")
    at_least = checks["sampled_tokens_at_least"]
    return ok and at_least["value"] >= at_least["limit"]


# ----------------------------------------------------------------- run
@dataclasses.dataclass
class Result:
    cell: Cell
    seed: int
    setup_s: float
    build_s: float
    e2e: Dict[str, Any]
    peak_bytes: int
    drv: Driver
    stats_open: Dict[str, float]
    stats_close: Dict[str, float]
    window_steps: tuple  # engine step range (first, last + 1) in the window
    prefills: List[int]  # prompt lengths of the prefills started in the window
    trace: Any = None  # trace.Trace of the profiled slice
    slice_steps: tuple = (0, 0)
    slice_live: tuple = ()  # requests in their slots after the slice
    checks: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    gaps: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    correct: bool = False
    check_s: float = 0.0


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             control: Optional[str] = None,
             fault: Optional[Callable] = None, clock: Callable = time.perf_counter,
             sleep: Callable = time.sleep) -> Result:
    """One run. ``control`` also reads the control's (``compare_sample``);
    ``fault`` changes the engine after its warm-up, and ``clock``/``sleep``
    replace the wall clock (the tests' faults and virtual time)."""
    on_gpu = torch.device(device).type == "cuda"
    build_s = 0.0
    if on_gpu:
        from repro_torch.kernels import build

        t = time.perf_counter()
        build.build_all()
        build_s = time.perf_counter() - t
    conf, c = cell.conf, cell.cell
    params = weights.make(conf, seed, device)
    eng = build_engine(conf, c, params, device)
    warm_up(eng, cell.mix, conf, seed)
    if fault is not None:
        fault(eng)
    warm_s = float(c["warm_s"])
    trace_steps = int(c.get("trace_steps", 48)) if trace else 0
    # One schedule for the traced and the untraced runs: its tail covers
    # the slice after the window.
    horizon = warm_s + seconds + SCHEDULE_TAIL_S
    arrivals = traffic.schedule(cell.mix, float(c["rate_rps"]), horizon, seed, conf["vocab_size"],
                                int(c["max_seq_len"]))
    costs = page_costs(conf)
    span = (lambda name: torch.profiler.record_function(name)) if trace else None
    t0 = clock()
    setup_s = time.perf_counter() - t_start
    drv = Driver(eng, arrivals, t0, costs, span, clock, sleep)
    ws, we = t0 + warm_s, t0 + warm_s + seconds
    drv.run(stop_at=ws)
    stats_open, step_open = engine_stats(eng), eng.stats.steps
    n_recs_open = len(drv.recs)
    backlog_open = drv.backlog(ws)
    drv.run(stop_at=we)
    stats_close, step_close = engine_stats(eng), eng.stats.steps
    backlog_close = drv.backlog(we)
    prefills = [len(r.arrival.prompt) for r in drv.recs[n_recs_open:]]
    if on_gpu:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    e2e = end_to_end(drv, ws, we)
    e2e["peak_mem_gib"] = peak / 2**30 if on_gpu else None
    e2e["_backlog"] = (backlog_open, backlog_close)
    res = Result(cell, seed, setup_s, build_s, e2e, peak, drv, stats_open, stats_close,
                 (step_open, step_close), prefills)
    if trace:
        _traced_slice(res, trace_steps, on_gpu)
    # The check: the program's state goes first, then the reference runs
    # over the sampled requests against the same weights.
    recs = sample(drv, seed, int(c["sample_tokens"]), we)
    drv.eng = None
    del eng
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    res.gaps = compare_sample(params, conf, drv, recs, precision=control or "f32")
    res.check_s = time.perf_counter() - t_check
    res.checks = check(numbers(res.gaps), c["limits"], int(c["sample_tokens"]))
    res.correct = passed(res.checks)
    return res


def _traced_slice(res: Result, steps: int, on_gpu: bool) -> None:
    """``steps`` more engine steps of the same traffic under the profiler,
    after the window (the profiler slows every later launch)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from tierbench import trace as trace_mod

    drv = res.drv
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_gpu else [])
    first = drv.eng.stats.steps
    with profile(activities=acts) as prof:
        with record_function(trace_mod.SLICE):
            drv.run(stop_at=math.inf, max_steps=steps)
            if on_gpu:
                torch.cuda.synchronize()
    drv.snapshot()  # the cache after the slice's last call
    res.slice_steps = (first, drv.eng.stats.steps)
    res.slice_live = tuple(r for r in drv.live if r is not None)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"trace-{res.cell.name}.json"
    prof.export_chrome_trace(str(path))
    res.trace = trace_mod.read(str(path))
    path.unlink()


# ------------------------------------------------------------ per layer
def per_layer(res: Result) -> Dict[str, float]:
    """Each per-layer metric of the manifest that lists this cell (or lists
    none), read by ``metrics/<name>.py``; a reader that finds nothing to
    read returns None and its metric is left out."""
    out = {}
    for spec in res.cell.manifest["per_layer"]:
        if "workloads" in spec and res.cell.name not in spec["workloads"]:
            continue
        mod = importlib.import_module(f"tierbench.metrics.{spec['name']}")
        v = mod.read(res)
        if v is not None:
            out[spec["name"]] = {"value": float(v), "unit": spec["unit"]}
    return out


def recent_rows(lv: np.ndarray, totals: np.ndarray, pt: int) -> np.ndarray:
    """Dense recent rows each active slot's decode step reads, the new token
    included: ``lv`` the placement levels [layers, active, pages] before the
    step, ``totals`` [active] its tokens. The engine pages every layer out
    at once, so the recent window starts after the last page that any layer
    holds, in every layer: also in one that released its older pages
    (level 0 below pages another layer holds)."""
    held = (lv != 0).any(axis=0)  # [active, pages]
    ends = np.where(held.any(-1), held.shape[-1] - held[:, ::-1].argmax(-1), 0)
    return totals - ends * pt + 1


def decode_least_s(res: Result, step: int, slots, totals) -> float:
    """The least time of one decode step (``peaks.least_time_s``) from the
    cache it read: each active slot's device pages and recent rows."""
    conf = res.cell.conf
    fam = families.of(conf)
    m = fam.shape(conf)
    t = conf["tiering"]
    pt = int(t["page_tokens"])
    lv = res.drv.levels_at(step)[:, slots]  # [layers, active, pages]
    warm = (lv == WARM).sum(-1)
    cold = (lv == COLD).sum(-1)
    rows = lv.shape[0] * int(recent_rows(lv, totals, pt).sum())  # over layers and slots
    keys = int((warm + cold).sum()) * pt + rows
    kv_bytes = (int(warm.sum()) * counts.page_bytes(m, pt, int(t["warm_bits"]))
                + int(cold.sum()) * counts.page_bytes(m, pt, int(t["cold_bits"]))
                + rows * 2 * m.kv * m.hd * counts.BF16)
    flops, nbytes = fam.decode_step(conf, res.drv.shape[1], keys, kv_bytes)
    return peaks.least_time_s(flops, nbytes)


def stat_delta(res: Result, key: str) -> float:
    return res.stats_close[key] - res.stats_open[key]
