"""The program's own spans and counters (``repro_torch.tracing``), read for
the per-layer metrics: sums per span over the window's engine steps,
counter deltas, and the traced slice's device-idle time placed on the
program span that was innermost open.

The records are those of the tracer of the engine built last in the
process (``tracing.current()``), the run's engine. A record is ``(name,
step, parent, t0_ns, t1_ns)`` on ``time.perf_counter_ns``; a counter's has
``t0_ns`` None and its increment last. Against a program that has no tracer,
or once the steps asked for have left its ring, every reading is None.

The program's clock is not the profiler's: each traced step has one harness
span ``tierbench.step`` on the trace's clock and one program span
``engine.step``, and the offset between the clocks is the median of their
start differences over the slice's steps.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple

STEP = "engine.step"
WINDOW = "engine.window"
HARNESS_STEP = "tierbench.step"
OUTSIDE = "outside the program"


def _tracer():
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.current()


def records(res, steps: Optional[Tuple[int, int]] = None) -> Optional[List[tuple]]:
    """The program's records of engine steps ``steps`` (the window's by
    default), or None."""
    first, last = steps or res.window_steps
    tr = _tracer()
    if tr is None or last <= first:
        return None
    return tr.records(first, last)


def span_seconds(res, parent: str, names: Sequence[str]) -> Optional[float]:
    """Seconds of the window's spans named ``names`` opened directly inside
    ``parent``."""
    recs = records(res)
    if recs is None:
        return None
    return sum(r[4] - r[3] for r in recs
               if r[3] is not None and r[2] == parent and r[0] in names) * 1e-9


def per_step_ms(res, names: Sequence[str], parent: str = STEP) -> Optional[float]:
    """Milliseconds a window step spends in the spans ``names`` opened
    directly inside ``parent`` (the step)."""
    s = span_seconds(res, parent, names)
    n = res.window_steps[1] - res.window_steps[0]
    return None if s is None or not n else s / n * 1e3


def per_boundary_ms(res, name: str) -> Optional[float]:
    """Milliseconds a tier-window boundary in the window spends in its
    child span ``name``."""
    recs = records(res)
    if recs is None:
        return None
    n = sum(1 for r in recs if r[0] == WINDOW and r[3] is not None)
    return span_seconds(res, WINDOW, (name,)) / n * 1e3 if n else None


def step_self_ms(res) -> Optional[float]:
    """The steps' own milliseconds per window step: each ``engine.step``'s
    duration less its child spans'."""
    recs = records(res)
    n = res.window_steps[1] - res.window_steps[0]
    if recs is None or not n:
        return None
    spans = [r for r in recs if r[3] is not None]
    own = sum(r[4] - r[3] for r in spans if r[0] == STEP)
    own -= sum(r[4] - r[3] for r in spans if r[2] == STEP)
    return own * 1e-9 / n * 1e3


def counter(res, name: str) -> Optional[int]:
    """The counter's increments over the window's steps."""
    recs = records(res)
    if recs is None:
        return None
    return sum(r[4] for r in recs if r[3] is None and r[0] == name)


# ------------------------------------------------ the slice's idle time
def aligned_spans(res) -> Optional[List[Tuple[float, float, str]]]:
    """The slice's program spans as (start, end, name), in seconds on the
    trace's clock, or None where the slice's harness and program steps do
    not pair up."""
    tr = res.trace
    if tr is None:
        return None
    recs = records(res, res.slice_steps)
    if not recs:
        return None
    spans = [r for r in recs if r[3] is not None]
    prog = sorted((r[1], r[3]) for r in spans if r[0] == STEP)
    lo, hi = tr.window
    harness = sorted(a for a, b, name in tr.spans
                     if name == HARNESS_STEP and lo <= a and b <= hi)
    if not prog or len(prog) != len(harness):
        return None
    off = statistics.median(h - t0 * 1e-9 for h, (_, t0) in zip(harness, prog))
    return [(r[3] * 1e-9 + off, r[4] * 1e-9 + off, r[0]) for r in spans]


def innermost(spans: Sequence[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """Nested spans flattened into disjoint (start, end, name) pieces, each
    named by the innermost span open over it; time inside no span is left
    out."""
    events = []
    for i, (a, b, _) in enumerate(spans):
        # At one instant: ends before starts, an inner end before its
        # parent's, a parent's start before its child's.
        events.append((a, 1, -b, i))
        events.append((b, 0, -a, i))
    events.sort()
    out: List[Tuple[float, float, str]] = []
    stack: List[int] = []
    prev = None
    for t, start, _, i in events:
        if stack and t > prev:
            out.append((prev, t, spans[stack[-1]][2]))
        if start:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        else:
            stack.remove(i)
        prev = t
    return out


def idle_by_span(res) -> Optional[Dict[str, float]]:
    """The slice's device-idle seconds by the program span innermost open
    over them (``OUTSIDE`` where none was), or None without device events
    or aligned spans."""
    tr = res.trace
    if tr is None or not tr.device:
        return None
    spans = aligned_spans(res)
    if spans is None:
        return None
    lo, hi = tr.window
    edges = [lo] + [x for iv in tr._union() for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    pieces = innermost(spans)
    out: Dict[str, float] = {}
    i = j = 0
    while i < len(gaps) and j < len(pieces):
        a = max(gaps[i][0], pieces[j][0])
        b = min(gaps[i][1], pieces[j][1])
        if b > a:
            out[pieces[j][2]] = out.get(pieces[j][2], 0.0) + (b - a)
        if gaps[i][1] < pieces[j][1]:
            i += 1
        else:
            j += 1
    out[OUTSIDE] = max(sum(b - a for a, b in gaps) - sum(out.values()), 0.0)
    return out


def idle_in_program_pct(res) -> Optional[float]:
    """Share of the slice's device-idle time in which a program span other
    than ``engine.step`` was innermost open."""
    idle = idle_by_span(res)
    if idle is None:
        return None
    total = sum(idle.values())
    if total <= 0:
        return None
    named = sum(v for k, v in idle.items() if k not in (STEP, OUTSIDE))
    return 100.0 * named / total
