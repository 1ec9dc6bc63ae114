"""Spans and counters inside the serving engine, its KV cache and the media
pipeline, keyed by engine step.

Each ``TieredEngine`` owns one ``Tracer`` and hands it to its cache and the
cache's migration pipeline. A span (``Tracer.span``, a context manager)
records its name, the name of the span it opened inside (None at the top),
the engine step it belongs to and its start and end on
``time.perf_counter_ns``. A counter (``Tracer.count``) records a named
increment with the same keys and no times. The step is ``Tracer.step``,
which the engine sets to ``EngineStats.steps`` when ``step``,
``start_request`` or ``finish`` is entered.

Records go into a ring of ``RING`` entries, oldest overwritten first;
``Tracer.records`` returns the records of a range of steps, or None once
any of them has left the ring (never a partial range). Apart from the ring,
``Tracer.totals`` keeps each (parent, name)'s all-time span nanoseconds:
``EngineStats``' clocks (``decode_s``, ``daemon_s``, ``prefill_s``,
``window_s``) are sums of these, so each clock and its spans are one
reading of the clock.

While a ``torch.profiler`` session records, each span also opens
``torch.profiler.record_function("repro_torch.<name>")``, so a profile shows
the spans as ``user_annotation`` events beside the kernels on the device
trace's clock. With no profiler active no ``record_function`` is entered:
the check costs one call per span.

``current()`` is the tracer of the engine built last in the process, which
stays reachable after the engine is freed.

A record is a tuple ``(name, step, parent, t0_ns, t1_ns)``; a counter's has
``t0_ns`` None and the increment in place of ``t1_ns``.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

RING = 1 << 18
PROFILER_PREFIX = "repro_torch."

_now = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled
_current: Optional["Tracer"] = None


def current() -> Optional["Tracer"]:
    """The tracer of the engine built last in this process, or None."""
    return _current


def set_current(tracer: "Tracer") -> None:
    global _current
    _current = tracer


class Span:
    __slots__ = ("_tr", "name", "parent", "step", "t0", "t1", "_rf")

    def __init__(self, tracer: "Tracer", name: str):
        self._tr = tracer
        self.name = name

    def __enter__(self) -> "Span":
        tr = self._tr
        self.parent = tr._open
        self.step = tr.step
        tr._open = self.name
        if _profiling():
            self._rf = torch.profiler.record_function(PROFILER_PREFIX + self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self.t1 = _now()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        tr = self._tr
        tr._open = self.parent
        tr._ring[tr._n & tr._mask] = (self.name, self.step, self.parent, self.t0, t1)
        tr._n += 1
        key = (self.parent, self.name)
        tr.totals[key] = tr.totals.get(key, 0) + (t1 - self.t0)
        return False


class Tracer:
    def __init__(self, capacity: int = RING):
        if capacity & (capacity - 1):
            raise ValueError(f"ring capacity {capacity} is not a power of two")
        self.capacity = capacity
        self._mask = capacity - 1
        self._ring: List[Optional[tuple]] = [None] * capacity
        self._n = 0  # records ever written
        self._open: Optional[str] = None  # innermost open span's name
        self.step = 0
        self.totals: Dict[Tuple[Optional[str], str], int] = {}

    def span(self, name: str) -> Span:
        return Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        self._ring[self._n & self._mask] = (name, self.step, self._open, None, n)
        self._n += 1

    def seconds(self, keys: Iterable[Tuple[Optional[str], str]]) -> float:
        """All-time seconds of the spans named by (parent, name) keys."""
        return sum(self.totals.get(k, 0) for k in keys) * 1e-9

    def records(self, first_step: int, last_step: int) -> Optional[List[tuple]]:
        """Records of engine steps ``first_step`` to ``last_step - 1`` in the
        order they closed, or None if any of them has left the ring."""
        n, cap = self._n, self.capacity
        if n <= cap:
            held = self._ring[:n]
        else:
            i = n & self._mask
            held = self._ring[i:] + self._ring[:i]
            # Steps only grow, so the oldest record held bounds what was lost.
            if held[0][1] >= first_step:
                return None
        return [r for r in held if first_step <= r[1] < last_step]


def traced(name: str):
    """Method decorator: the call is a span of ``self.tracer``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(self, *args, **kwargs):
            with Span(self.tracer, name):
                return fn(self, *args, **kwargs)

        return call

    return wrap
