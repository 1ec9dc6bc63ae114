"""Continuous-batching scheduler over one or more ``TieredEngine`` replicas,
after ``repro.frontend.scheduler``.

Virtual time: one scheduler step = one decode step on every replica with
active slots. Each step the scheduler

  1. admits arrivals (token-budget admission over live engine headroom;
     refuse or queue instead of OOM),
  2. places queued work — highest SLA weight first, FIFO within a class;
     when the routed replica is full, a strictly-heavier arrival preempts
     the lightest preemptible victim: the victim slot's device pages demote
     through the media pipeline to the host tier (``preempt_slot``) and the
     request re-enters the queue WITH its pages parked,
  3. advances chunked prefills (one chunk per slot per step, interleaved
     with other slots' decode; the model prefill executes when the last
     chunk lands, emitting the first token),
  4. decodes, folding per-request telemetry (queue delay, TTFT, TBT,
     preemption count) into ``FrontendStats``.

Preempted requests resume via ``resume_into`` — host pages swap back in
through the same cohort machinery, zero tokens re-prefilled. Per-window
decoded-token demand per tenant accumulates in ``demand_windows``;
``feed_arbiter`` pushes it into any object with a
``record_scheduled_demand(dict)`` method (``core.arbiter.BudgetArbiter``,
whose ``fleet_report`` then prices fleets against it).

A replica failure (``fail_replica``) parks the dead replica's running slots
bit-exactly and resumes them on a live replica: the parked KV is host memory
and restores into any engine of the same geometry.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.frontend.admission import (
    DEFAULT_CLASSES,
    REFUSE,
    AdmissionController,
    SLAClass,
)
from repro_torch.frontend.router import ReplicaRouter
from repro_torch.frontend.traces import ArrivalEvent
from repro_torch.serving.engine import PreemptedRequest, Request, TieredEngine


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle + telemetry of one traced request."""

    event: ArrivalEvent
    state: str = "arriving"  # arriving|queued|prefill|running|preempted|done|refused
    request: Optional[Request] = None
    replica: int = -1
    slot: int = -1
    place_step: int = -1  # first slot reservation (queue-delay endpoint)
    first_token_step: int = -1
    done_step: int = -1
    chunks_left: int = 0
    preemptions: int = 0
    parked: Optional[PreemptedRequest] = None
    token_steps: List[int] = dataclasses.field(default_factory=list)

    def queue_delay(self) -> int:
        return self.place_step - self.event.step

    def ttft(self) -> int:
        return self.first_token_step - self.event.step

    def tbt(self) -> np.ndarray:
        return np.diff(np.asarray(self.token_steps, np.int64))


def pctl(values: Sequence[float], q: float) -> float:
    v = np.asarray(list(values), np.float64)
    if v.size == 0:
        return 0.0
    return float(np.percentile(v, q))


@dataclasses.dataclass
class FrontendStats:
    """Fleet-level request telemetry, grouped by SLA class."""

    records: List[RequestRecord]
    classes: Tuple[SLAClass, ...]
    steps: int = 0
    refused: int = 0
    preemptions: int = 0
    resumes: int = 0
    re_prefill_tokens: int = 0
    resumed_pages: int = 0
    decoded_tokens: int = 0
    # Replica-failure accounting: failures injected, running slots parked
    # bit-exactly off the failed replica, and requests (parked + prefilling
    # + queued) re-routed to live replicas. The failover contract keeps
    # ``re_prefill_tokens`` at 0: parked pages restore on the new replica.
    replica_failures: int = 0
    failover_parked: int = 0
    failover_requeued: int = 0
    # Per-window decoded tokens per tenant id — the scheduler-measured
    # decode demand ``BudgetArbiter.record_scheduled_demand`` consumes.
    demand_windows: List[Dict[int, float]] = dataclasses.field(default_factory=list)

    def done(self, sla: Optional[int] = None) -> List[RequestRecord]:
        return [
            r for r in self.records
            if r.state == "done" and (sla is None or r.event.sla == sla)
        ]

    def summary(self) -> Dict[str, object]:
        """Canonical (JSON-stable) roll-up: per-class percentiles + global
        preemption accounting. Two identical runs produce identical dicts —
        the serving_slo determinism probe compares these directly."""
        out: Dict[str, object] = {
            "steps": self.steps,
            "completed": len(self.done()),
            "refused": self.refused,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "resumed_pages": self.resumed_pages,
            "re_prefill_tokens": self.re_prefill_tokens,
            "decoded_tokens": self.decoded_tokens,
            "replica_failures": self.replica_failures,
            "failover_parked": self.failover_parked,
            "failover_requeued": self.failover_requeued,
            "preemption_rate": round(
                self.preemptions / max(len(self.done()), 1), 6
            ),
        }
        for i, cls in enumerate(self.classes):
            recs = self.done(i)
            ttfts = [r.ttft() for r in recs]
            tbts = (
                np.concatenate([r.tbt() for r in recs])
                if recs else np.zeros(0, np.int64)
            )
            delays = [r.queue_delay() for r in recs]
            out[cls.name] = {
                "completed": len(recs),
                "ttft_p50": round(pctl(ttfts, 50), 6),
                "ttft_p99": round(pctl(ttfts, 99), 6),
                "tbt_p50": round(pctl(tbts, 50), 6),
                "tbt_p99": round(pctl(tbts, 99), 6),
                "queue_delay_mean": round(float(np.mean(delays)) if delays else 0.0, 6),
                "ttft_target": cls.ttft_target_steps,
                "ttft_slo_hit_rate": round(
                    float(np.mean([t <= cls.ttft_target_steps for t in ttfts]))
                    if ttfts else 0.0, 6
                ),
                "preemptions": sum(r.preemptions for r in recs),
            }
        return out

    def demand_by_window(self, tenant_names: Sequence[str]) -> List[Dict[str, float]]:
        """Rekey the per-window tenant-id demand onto arbiter tenant names
        (index-aligned: tenant id i -> tenant_names[i])."""
        return [
            {tenant_names[t]: float(v) for t, v in w.items()}
            for w in self.demand_windows
        ]

    def feed_arbiter(self, arbiter, tenant_names: Sequence[str]) -> int:
        """Push every scheduling window's measured decode demand into the
        arbiter; its next ``fleet_report()`` prices fleets against this
        instead of the synthetic telemetry constant. Returns windows fed."""
        windows = self.demand_by_window(tenant_names)
        for w in windows:
            arbiter.record_scheduled_demand(w)
        return len(windows)


class ContinuousScheduler:
    """SLA-aware continuous batching over N engine replicas."""

    def __init__(
        self,
        engines: Sequence[TieredEngine],
        events: Sequence[ArrivalEvent],
        vocab_size: int,
        classes: Sequence[SLAClass] = DEFAULT_CLASSES,
        admission: Optional[AdmissionController] = None,
        router: Optional[ReplicaRouter] = None,
        prefill_chunk_tokens: int = 16,
        window_steps: Optional[int] = None,
    ):
        if not engines:
            raise ValueError("need at least one engine replica")
        self.engines = list(engines)
        self.vocab = vocab_size
        self.classes = tuple(classes)
        for e in events:
            if not (0 <= e.sla < len(self.classes)):
                raise ValueError(f"event {e.seq} names unknown SLA class {e.sla}")
        self.admission = admission or AdmissionController(self.classes)
        self.router = router or ReplicaRouter(len(self.engines))
        self.chunk = max(int(prefill_chunk_tokens), 1)
        self.window_steps = int(window_steps or self.engines[0].ts.window_steps)
        self.records = [RequestRecord(e) for e in sorted(events, key=lambda e: (e.step, e.seq))]
        self.queue: List[int] = []  # record indices awaiting placement
        # Per-replica slot -> record index (running) and reserved prefills.
        self._running: List[Dict[int, int]] = [dict() for _ in self.engines]
        self._prefilling: List[Dict[int, int]] = [dict() for _ in self.engines]
        self.stats = FrontendStats(records=self.records, classes=self.classes)
        self._win_demand: Dict[int, float] = {}
        self._steps_in_window = 0

    # ------------------------------------------------------------- helpers
    def _cls(self, rec: RequestRecord) -> SLAClass:
        return self.classes[rec.event.sla]

    def _free_slots(self, r: int) -> List[int]:
        eng = self.engines[r]
        held = set(self._prefilling[r]) | set(self._running[r])
        return [s for s in eng.free_slots() if s not in held]

    def _outstanding(self) -> List[int]:
        # Engine outstanding + prefill reservations the engine can't see yet.
        out = []
        for r, eng in enumerate(self.engines):
            extra = sum(
                self.records[i].event.prompt_len + self.records[i].event.max_new_tokens
                for i in self._prefilling[r].values()
            )
            out.append(eng.outstanding_tokens() + extra)
        return out

    def _queued_of_class(self, sla: int) -> int:
        return sum(1 for i in self.queue if self.records[i].event.sla == sla)

    def _live(self) -> bool:
        return bool(
            self.queue
            or any(self._prefilling[r] or self._running[r] for r in range(len(self.engines)))
        )

    # ------------------------------------------------------------ lifecycle
    def _admit_arrivals(self, step: int, cursor: int) -> int:
        while cursor < len(self.records) and self.records[cursor].event.step <= step:
            rec = self.records[cursor]
            outstanding = self._outstanding()
            r = self.router.route(rec.event, outstanding)
            rec.replica = r
            decision = self.admission.decide(
                rec.event,
                capacity_tokens=sum(e.token_capacity() for e in self.engines),
                outstanding_tokens=sum(outstanding),
                headroom_tokens=self.engines[r].device_headroom_tokens(),
                free_slot=bool(self._free_slots(r)),
                queued_of_class=self._queued_of_class(rec.event.sla),
            )
            if decision == REFUSE:
                rec.state = "refused"
                self.stats.refused += 1
                self.router.note_done(rec.event)
            else:  # ADMIT and QUEUE both enter the placement queue; ADMIT
                # is guaranteed to place this same step (slot + headroom).
                rec.state = "queued"
                self.queue.append(cursor)
            cursor += 1
        return cursor

    def _reroute(self, rec: RequestRecord) -> None:
        """Rebind one record off its (dead) replica: release the affinity
        hold, then route again — the router skips dead replicas."""
        self.router.note_done(rec.event)
        rec.replica = self.router.route(rec.event, self._outstanding())
        self.stats.failover_requeued += 1

    def fail_replica(self, r: int, step: int) -> None:
        """Hard replica failure: drain replica ``r`` without dropping a
        request. Running slots park bit-exactly (device pages demote to the
        host tier, payloads detach — ``PreemptedRequest`` is portable across
        same-geometry replicas) and requeue with their pages attached, so
        resume on a live replica re-prefills zero tokens. Prefilling slots
        haven't emitted a token yet and simply requeue; queued arrivals
        rebind. Raises if ``r`` is the last live replica."""
        self.router.mark_down(r)
        self.stats.replica_failures += 1
        eng = self.engines[r]
        for slot in sorted(self._running[r]):
            idx = self._running[r][slot]
            rec = self.records[idx]
            rec.parked = eng.preempt_slot(slot)
            rec.state = "preempted"
            rec.slot = -1
            rec.preemptions += 1
            self.stats.failover_parked += 1
            self.queue.append(idx)
        self._running[r].clear()
        for slot in sorted(self._prefilling[r]):
            idx = self._prefilling[r][slot]
            rec = self.records[idx]
            rec.state = "queued"
            rec.slot = -1
            self.queue.append(idx)
        self._prefilling[r].clear()
        for idx in list(self.queue):
            rec = self.records[idx]
            if rec.replica == r:
                self._reroute(rec)

    def _pick_victim(self, r: int, weight: float) -> Optional[int]:
        """Lightest preemptible running slot strictly below ``weight``;
        youngest first (least KV to demote), slot index tie-break."""
        cands = []
        for slot, idx in self._running[r].items():
            rec = self.records[idx]
            cls = self._cls(rec)
            if cls.preemptible and cls.weight < weight:
                cands.append((cls.weight, -rec.place_step, slot))
        if not cands:
            return None
        return min(cands)[2]

    def _place(self, step: int) -> None:
        # Heaviest class first; FIFO (trace order) within a class. A pass
        # places into free slots, then lets strictly-heavier work preempt.
        order = sorted(
            self.queue, key=lambda i: (-self._cls(self.records[i]).weight, i)
        )
        for idx in order:
            rec = self.records[idx]
            if rec.replica in self.router.dead:
                # Defensive: a record still bound to a replica that died
                # after routing rebinds before placement.
                self._reroute(rec)
            r = rec.replica
            eng = self.engines[r]
            free = self._free_slots(r)
            if not free:
                victim_slot = self._pick_victim(r, self._cls(rec).weight)
                if victim_slot is None:
                    continue
                vidx = self._running[r].pop(victim_slot)
                vrec = self.records[vidx]
                vrec.parked = eng.preempt_slot(victim_slot)
                vrec.state = "preempted"
                vrec.slot = -1
                vrec.preemptions += 1
                self.stats.preemptions += 1
                self.queue.append(vidx)
                free = [victim_slot]
            slot = free[0]
            self.queue.remove(idx)
            rec.slot = slot
            if rec.place_step < 0:
                rec.place_step = step
            if rec.parked is not None:
                # Resume: parked host pages swap back in, zero re-prefill.
                eng.resume_into(slot, rec.parked)
                rec.parked = None
                rec.state = "running"
                self._running[r][slot] = idx
                self.stats.resumes += 1
            else:
                rec.state = "prefill"
                rec.chunks_left = max(
                    math.ceil(rec.event.prompt_len / self.chunk), 1
                )
                self._prefilling[r][slot] = idx

    def _advance_prefills(self, step: int) -> None:
        for r, eng in enumerate(self.engines):
            for slot in sorted(self._prefilling[r]):
                idx = self._prefilling[r][slot]
                rec = self.records[idx]
                rec.chunks_left -= 1
                if rec.chunks_left > 0:
                    continue
                # Final chunk: execute the model prefill, emit first token.
                ev = rec.event
                rec.request = eng.make_request(
                    ev.prompt(self.vocab), ev.max_new_tokens, tenant=ev.tenant
                )
                eng.start_request(slot, rec.request)
                rec.first_token_step = step
                rec.token_steps.append(step)
                rec.state = "running"
                del self._prefilling[r][slot]
                self._running[r][slot] = idx
                self.stats.decoded_tokens += 1
                self._win_demand[ev.tenant] = self._win_demand.get(ev.tenant, 0.0) + 1.0

    def _decode(self, step: int) -> None:
        for r, eng in enumerate(self.engines):
            if not self._running[r]:
                continue
            eng.step()
            for slot in sorted(self._running[r]):
                idx = self._running[r][slot]
                rec = self.records[idx]
                rec.token_steps.append(step)
                self.stats.decoded_tokens += 1
                self._win_demand[rec.event.tenant] = (
                    self._win_demand.get(rec.event.tenant, 0.0) + 1.0
                )
                if rec.request.done:
                    rec.state = "done"
                    rec.done_step = step
                    del self._running[r][slot]
                    self.router.note_done(rec.event)

    def _close_window(self) -> None:
        self.stats.demand_windows.append(dict(self._win_demand))
        self._win_demand = {}
        self._steps_in_window = 0

    # ------------------------------------------------------------------ run
    def run(
        self,
        max_steps: int = 10_000,
        failures: Optional[Dict[int, int]] = None,
    ) -> FrontendStats:
        """Drive the trace to completion. ``failures`` maps a virtual step
        to a replica index that hard-fails at the top of that step (fault
        injection — see ``fail_replica``)."""
        step, cursor = 0, 0
        while step < max_steps and (cursor < len(self.records) or self._live()):
            if failures and step in failures:
                self.fail_replica(failures[step], step)
            cursor = self._admit_arrivals(step, cursor)
            self._place(step)
            # Decode BEFORE finishing prefills: a slot whose last chunk lands
            # this step emits its first token now and begins decoding next
            # step — never two tokens in one virtual step.
            self._decode(step)
            self._advance_prefills(step)
            self._steps_in_window += 1
            if self._steps_in_window >= self.window_steps:
                self._close_window()
            step += 1
        if self._win_demand or self._steps_in_window:
            self._close_window()
        self.stats.steps = step
        for eng in self.engines:
            es = eng.finish()
            self.stats.re_prefill_tokens += es.re_prefill_tokens
            self.stats.resumed_pages += es.resumed_pages
        return self.stats
