"""Deterministic, virtual-time fault injection for backing media, after
``repro.media.faults``.

Faults are keyed on window indices (the window clock advances at the same
boundaries in serial and async replay), and fault selection is resolved when
the plan is built (seeded numpy), so replaying a ``FaultPlan`` uses no RNG:
queries are pure functions of (plan, device, window, op counter).

  ==========  ==========================================================
  kind        effect
  ==========  ==========================================================
  stall       every queue submission in the window pays ``stall_s`` per op
  brownout    service time for the window is dilated by ``1 / bw_scale``
  down        stage attempts abort after bounded retries, planned cohorts
              touching the device are deferred, its tiers are quarantined
  transient   the ``index``-th demand stage attempt on the device in the
              window fails once (retried within the tick)
  corrupt     the ``index``-th payload staged from the device in the
              window gets a flipped byte in the pinned ring (caught by the
              end-to-end CRC, repaired from the pristine copy)
  ==========  ==========================================================
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np

KINDS = ("stall", "brownout", "down", "transient", "corrupt")

# Bounded retry for stage attempts that hit a transient fault or a down
# device: after this many failures the cohort is aborted (pages stay at
# their source; the next window boundary re-plans them).
MAX_STAGE_RETRIES = 3


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault on one device over a half-open window range."""

    kind: str  # one of KINDS
    device: str  # MediaDevice name, e.g. "cxl_hw"
    window0: int  # first affected window (inclusive)
    window1: int = -1  # past-the-end window; -1 => window0 + 1
    stall_s: float = 0.0  # kind == "stall": extra seconds per op
    bw_scale: float = 1.0  # kind == "brownout": effective-bw multiplier
    index: int = 0  # kind in {transient, corrupt}: k-th op in window

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "brownout" and not 0.0 < self.bw_scale <= 1.0:
            raise ValueError("brownout needs 0 < bw_scale <= 1")
        if self.kind == "stall" and self.stall_s < 0.0:
            raise ValueError("stall_s must be >= 0")
        if self.index < 0:
            raise ValueError("index must be >= 0")

    @property
    def window_end(self) -> int:
        return self.window1 if self.window1 > self.window0 else self.window0 + 1

    def active(self, window: int) -> bool:
        return self.window0 <= window < self.window_end


class FaultPlan:
    """A deterministic schedule of ``FaultEvent``s, queryable per window."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: Tuple[FaultEvent, ...] = tuple(events)
        self._by_dev: Dict[str, List[FaultEvent]] = {}
        for e in self.events:
            self._by_dev.setdefault(e.device, []).append(e)

    def _active(self, device: str, window: int) -> List[FaultEvent]:
        return [e for e in self._by_dev.get(device, ()) if e.active(window)]

    def stall_s(self, device: str, window: int) -> float:
        return sum(e.stall_s for e in self._active(device, window) if e.kind == "stall")

    def bw_scale(self, device: str, window: int) -> float:
        scale = 1.0
        for e in self._active(device, window):
            if e.kind == "brownout":
                scale *= e.bw_scale
        return scale

    def down(self, device: str, window: int) -> bool:
        return any(e.kind == "down" for e in self._active(device, window))

    def transient_attempts(self, device: str, window: int) -> FrozenSet[int]:
        """Which demand-stage attempts (0-based, per window) fail once."""
        return frozenset(
            e.index for e in self._active(device, window) if e.kind == "transient"
        )

    def corrupt_payloads(self, device: str, window: int) -> FrozenSet[int]:
        """Which staged payloads (0-based, per window) get a byte flipped."""
        return frozenset(
            e.index for e in self._active(device, window) if e.kind == "corrupt"
        )

    @classmethod
    def seeded_storm(
        cls,
        device: str,
        seed: int = 0,
        windows: int = 16,
        down_windows: int = 2,
        n_transient: int = 3,
        n_corrupt: int = 2,
        stall_s: float = 10e-6,
        bw_scale: float = 0.5,
    ) -> "FaultPlan":
        """A full-spectrum storm on one device, resolved from ``seed`` now:
        a stall and a brownout stretch in the first half, a hard down
        stretch in the second half, and seeded transient/corrupt pinpricks
        scattered across the healthy windows."""
        if windows < 8:
            raise ValueError("seeded_storm needs at least 8 windows")
        rng = np.random.default_rng(seed)
        half = windows // 2
        down0 = half + int(rng.integers(0, max(half - down_windows - 2, 1)))
        events = [
            FaultEvent("stall", device, 1, 1 + max(half // 2, 1), stall_s=stall_s),
            FaultEvent("brownout", device, half // 2, half, bw_scale=bw_scale),
            FaultEvent("down", device, down0, down0 + down_windows),
        ]
        healthy = [
            w
            for w in range(1, windows)
            if not (down0 <= w < down0 + down_windows)
        ]
        for w in rng.choice(healthy, size=min(n_transient, len(healthy)), replace=False):
            events.append(FaultEvent("transient", device, int(w), index=0))
        for w in rng.choice(healthy, size=min(n_corrupt, len(healthy)), replace=False):
            events.append(FaultEvent("corrupt", device, int(w), index=0))
        return cls(events)


def default_plan(device: str = "host_dram_pcie", windows: int = 64) -> FaultPlan:
    """The chaos-soak plan (``faults=True`` without a plan): transient stage
    failures and payload corruption on the local device and ``device``, on
    every window. Both are fully recovered and bill no extra media bytes, so
    placements, billing and tokens stay what a clean run gives."""
    events = [
        FaultEvent(kind, dev, 1, windows)
        for kind in ("transient", "corrupt")
        for dev in dict.fromkeys(("hbm", device))  # de-duped, order-stable
    ]
    return FaultPlan(events)


class FaultyMediaDevice:
    """Wraps any media device with the fault plan's view of it: service
    times dilated window-uniformly (stall/brownout) and the per-window op
    counters that key transient and corruption faults, reset at every
    window boundary."""

    def __init__(self, base, plan: FaultPlan):
        self.base = base
        self.plan = plan
        self._window = 0
        self._stage_attempts = 0
        self._staged_payloads = 0

    @property
    def name(self) -> str:
        return self.base.name

    @property
    def read_bw(self) -> float:
        return self.base.read_bw

    @property
    def write_bw(self) -> float:
        return self.base.write_bw

    @property
    def fixed_latency_s(self) -> float:
        return self.base.fixed_latency_s

    @property
    def queue_depth(self) -> int:
        return self.base.queue_depth

    def note_window(self, window: int) -> None:
        self._window = int(window)
        self._stage_attempts = 0
        self._staged_payloads = 0

    def down_now(self) -> bool:
        return self.plan.down(self.name, self._window)

    def service_time_s(self, n_bytes: int, write: bool = False) -> float:
        base = self.base.service_time_s(n_bytes, write=write)
        return base / self.plan.bw_scale(self.name, self._window) + self.plan.stall_s(
            self.name, self._window
        )

    def batch_service_time_s(self, n_bytes: int, ops: int = 1, write: bool = False) -> float:
        # Brownout dilates the whole service (the fixed term too); stall
        # bills per op.
        base = self.base.batch_service_time_s(n_bytes, ops=ops, write=write)
        return base / self.plan.bw_scale(self.name, self._window) + ops * self.plan.stall_s(
            self.name, self._window
        )

    def next_stage_attempt(self) -> bool:
        """True if this demand stage attempt is scheduled to fail."""
        k = self._stage_attempts
        self._stage_attempts += 1
        return k in self.plan.transient_attempts(self.name, self._window)

    def next_staged_payload(self) -> bool:
        """True if this staged payload is scheduled to be corrupted."""
        k = self._staged_payloads
        self._staged_payloads += 1
        return k in self.plan.corrupt_payloads(self.name, self._window)
