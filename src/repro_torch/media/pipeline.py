"""Async, double-buffered migration pipeline over a phase-split executor,
after ``repro.media.pipeline``.

A window's migration plan runs as (src, dst) cohorts, each split into three
phases spread across engine decode steps instead of blocking the boundary:

  stage     — gather the cohort's payloads out of the source tier, retire
              them from the source page tables, and pin them in the staging
              ring (host-media cohorts) or hold them as device tensors
              (cohorts between the device pools). Bills the source read.
  transcode — one fused transcode kernel launch over the staged batch
              (skipped on the same-codec fast path).
  commit    — scatter into the destination tier, update placement, release
              ring credits. Bills the destination write.

One ``tick()`` — called by the engine after every decode step — advances the
oldest incomplete cohort by one phase and stages the next cohort while the
head is mid-flight (the double buffer: at most two cohorts hold staging
resources). Ring-credit shortage stalls the stage phase; nothing is dropped.

Speculative prefetch: ``submit_prefetch`` queues low-priority cohorts that
stage shadow copies of warming host pages through the ring's reserved slice
on ticks with no demand work. At the window boundary the executor
``claim``s held pages the plan decided to move (they ride their demand
cohort as ``prestaged`` rows, merged back into the payload at stage time so
the transcode input equals the no-prefetch run's) and ``discard``s the rest.

Each ``tick``, ``drain`` and phase is a span of the pipeline's
``tracing.Tracer`` (``pipeline.tick``, ``pipeline.drain``, ``pipeline.stage``,
``pipeline.transcode``, ``pipeline.commit``), and the busy and stalled ticks
and the prefetch hits and misses are counters there too.

Ring transit: each page's four arrays are serialized as one row of bytes
into its ring slot; demand cohorts carry a CRC32 per slot and a pristine
host copy, checked at every unpack (a mismatch is counted and repaired from
the copy). Payloads cross the phases as dicts of tensors: device tensors for
cohorts between the device pools, host tensors read out of the ring
otherwise; the executor moves what it transcodes onto its device.

The executor contract (``serving.kv_cache.TieredKVCache``):

  stage_cohort(rids, src, dst=None) -> {k_pay, k_sc, v_pay, v_sc}, or a
      ``{"class_rows": rows}`` marker for moves within one codec class
  peek_cohort(rids, src) -> payload       # non-destructive speculative read
  drop_source_copies(rids, src) -> None   # retire sources of prestaged pages
  transcode_cohort(payload, src, dst) -> payload
  commit_cohort(rids, payload, src, dst) -> per-rid landed levels
  page_stored_bytes(level) -> int
  device_of(level) -> str
  on_pipeline_drained() -> None

``serial=True`` is the equivalence oracle: ``submit`` drains every phase
inline through the same callbacks.
"""

from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.media.devices import MediaQueue
from repro_torch.media.faults import MAX_STAGE_RETRIES
from repro_torch.media.ringbuf import PinnedRing
from repro_torch.tracing import Tracer, traced

# Payload keys in staging order; pack/unpack relies on this ordering.
PAYLOAD_KEYS = ("k_pay", "k_sc", "v_pay", "v_sc")


def _rows_of(payload: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, list]:
    """Serialize a payload into one uint8 row per page (the four arrays'
    bytes back to back) and the per-key (shape, dtype) meta."""
    arrs = [torch.as_tensor(payload[k]) for k in PAYLOAD_KEYS]
    n = int(arrs[0].shape[0])
    meta = [(tuple(a.shape[1:]), a.dtype) for a in arrs]
    rows = torch.cat([a.contiguous().reshape(n, -1).view(torch.uint8) for a in arrs], dim=1)
    return rows, meta


def _split_rows(rows: torch.Tensor, meta) -> Dict[str, torch.Tensor]:
    """Inverse of ``_rows_of``: [n, bytes] uint8 -> {key: [n, *shape]}."""
    n = int(rows.shape[0])
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for key, (shape, dtype) in zip(PAYLOAD_KEYS, meta):
        nb = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        # clone: a fresh buffer at offset 0, so the dtype view is aligned.
        out[key] = rows[:, off:off + nb].clone().view(dtype).reshape((n,) + shape)
        off += nb
    return out


@dataclasses.dataclass
class _Cohort:
    rids: np.ndarray
    src: int
    dst: int
    phase: str = "pending"  # pending -> staged -> transcoded -> (committed)
    payload: Optional[Dict[str, torch.Tensor]] = None  # device staging hold
    ring_slots: Optional[List[int]] = None  # host staging (pinned ring)
    meta: Optional[list] = None  # per-key (shape, dtype)
    speculative: bool = False
    # Demand cohorts only: positions in ``rids`` whose payload was
    # prefetched and the raw source-codec rows for them.
    pre_idx: Optional[np.ndarray] = None
    pre_payload: Optional[Dict[str, torch.Tensor]] = None
    # Bounded-retry state and the ring-transit integrity sidecar (per-slot
    # CRC32 of the staged bytes, and the pristine rows to repair from).
    retries: int = 0
    next_retry_tick: int = 0
    crcs: Optional[List[int]] = None
    pristine: Optional[torch.Tensor] = None


class MigrationPipeline:
    def __init__(
        self,
        executor,
        ring: PinnedRing,
        queues: Dict[str, MediaQueue],
        step_period_s: float = 50e-6,
        serial: bool = False,
        tracer: Optional[Tracer] = None,
    ):
        self.executor = executor
        self.tracer = tracer or Tracer()
        self.ring = ring
        self.queues = queues
        self.step_period_s = step_period_s
        self.serial = serial
        self._queue: Deque[_Cohort] = deque()
        self._step = 0
        self._spec: Deque[_Cohort] = deque()
        # rid -> (src, ring slot, per-key meta, the page's speculative read time)
        self._held: Dict[int, Tuple[int, int, list, float]] = {}
        self.cohorts_done = 0
        self.pages_moved = 0
        # Ticks with demand work queued, and those of them in which no phase
        # progressed (ring-credit waits, fault backoff).
        self.busy_ticks = 0
        self.stall_ticks = 0
        self.prefetch_staged = 0  # pages that reached the held store
        self.prefetch_hits = 0  # held pages claimed by a boundary plan
        self.prefetch_misses = 0  # held pages the plan contradicted
        self.prefetch_cancelled = 0  # invalidated / dropped before staging
        # Held pages invalidated before a boundary met them (their source
        # moved or was freed mid-window): staged = hits + misses + these.
        self.prefetch_invalidated = 0
        self.prefetch_bytes = 0  # speculative source-read bytes (billed)
        # Speculative busy time per device, billed on the queues; a claimed
        # page's share is handed back out so the contention feedback that
        # shapes placement sees what a prefetch-free run would.
        self.prefetch_busy_by_device: Dict[str, float] = {}
        # Source-read time paid at the boundary for off-device demand stages.
        self.demand_swapin_s = 0.0
        self.fault_retries = 0
        self.cohorts_aborted = 0
        self.corruptions_injected = 0
        self.corruptions_detected = 0
        self.corruptions_repaired = 0

    # ------------------------------------------------------------------ API
    @property
    def busy(self) -> bool:
        return bool(self._queue)

    def submit(
        self,
        cohorts: Sequence[Tuple[np.ndarray, int, int]],
        prestaged: Optional[Dict[int, Dict[str, torch.Tensor]]] = None,
    ) -> int:
        """Enqueue phase-ordered (rids, src, dst) cohorts, chunked to half the
        ring; returns pages queued. ``prestaged`` maps rid -> raw
        source-codec payload row of a claimed prefetch."""
        chunk = max(self.ring.n_slots // 2, 1)
        n = 0
        for rids, src, dst in cohorts:
            rids = np.asarray(rids, np.int64)
            for lo in range(0, rids.size, chunk):
                part = rids[lo : lo + chunk]
                if not part.size:
                    continue
                c = _Cohort(part, int(src), int(dst))
                if prestaged:
                    idx = np.array(
                        [i for i, r in enumerate(part) if int(r) in prestaged],
                        np.int64,
                    )
                    if idx.size:
                        rows = [prestaged[int(part[i])] for i in idx]
                        c.pre_idx = idx
                        c.pre_payload = {
                            k: torch.stack([r[k] for r in rows]) for k in PAYLOAD_KEYS
                        }
                self._queue.append(c)
                n += int(part.size)
        if self.serial:
            self.drain()
        return n

    @traced("pipeline.tick")
    def tick(self) -> bool:
        """Advance one decode step's worth of migration work (demand first,
        speculation only when no demand work exists). Returns True if any
        phase progressed."""
        self._step += 1
        now = self._step * self.step_period_s
        if not self._queue:
            if self._spec:
                return self._tick_spec(now)
            return False
        self.busy_ticks += 1
        self.tracer.count("pipeline.busy_ticks")
        head = self._queue[0]
        progressed = False
        if head.phase == "transcoded":
            self._commit(head, now)
            self._queue.popleft()
            progressed = True
            if not self._queue:
                self.executor.on_pipeline_drained()
        elif head.phase == "aborted":
            # Retries exhausted: the cohort never left its source tier and
            # holds no credits; the next boundary re-plans its pages.
            self._queue.popleft()
            progressed = True
            if not self._queue:
                self.executor.on_pipeline_drained()
        elif head.phase == "staged":
            self._transcode(head)
            progressed = True
        else:  # pending
            progressed = self._stage(head, now)
        in_flight = sum(1 for c in self._queue if c.phase != "pending")
        if in_flight == 1 and len(self._queue) > 1:
            nxt = self._queue[1]
            if nxt.phase == "pending":
                progressed = self._stage(nxt, now) or progressed
        if not progressed:
            self.stall_ticks += 1
            self.tracer.count("pipeline.stall_ticks")
        return progressed

    @traced("pipeline.drain")
    def drain(self) -> int:
        """Run the demand queue to completion; returns pages committed."""
        budget = 24 * len(self._queue) + 64
        before = self.pages_moved
        while self._queue:
            budget -= 1
            if budget < 0:
                raise RuntimeError("migration pipeline failed to drain")
            self.tick()
        return self.pages_moved - before

    # --------------------------------------------------------------- phases
    def _uses_ring(self, c: _Cohort) -> bool:
        """Host-media payloads transit the pinned ring; moves between the
        device pools stay on the device (level 0 defines "local")."""
        local = self.executor.device_of(0)
        return (
            self.executor.device_of(c.src) != local
            or self.executor.device_of(c.dst) != local
        )

    @traced("pipeline.stage")
    def _stage(self, c: _Cohort, now: float) -> bool:
        if c.next_retry_tick > self._step:
            return False  # deterministic backoff after a faulted attempt
        faulty_src = self._faulty_device(c.src)
        faulty_dst = self._faulty_device(c.dst)
        if (faulty_src is not None and faulty_src.down_now()) or (
            faulty_dst is not None and faulty_dst.down_now()
        ):
            return self._fault_backoff(c)
        use_ring = self._uses_ring(c)
        slots = None
        if use_ring:
            slots = self.ring.try_acquire(int(c.rids.size))
            if slots is None:
                return False  # backpressured: retry next tick
        while faulty_src is not None and faulty_src.next_stage_attempt():
            # Injected transient: fails after the credits were granted; they
            # go straight back and the attempt retries within the tick (it
            # read and billed nothing). A persistent transient aborts.
            c.retries += 1
            self.fault_retries += 1
            if c.retries > MAX_STAGE_RETRIES:
                if slots is not None:
                    self.ring.release(slots)
                c.phase = "aborted"
                self.cohorts_aborted += 1
                return True
            if slots is not None:
                self.ring.release(slots)
                slots = self.ring.try_acquire(int(c.rids.size))
        if c.pre_idx is not None and c.pre_idx.size:
            fresh_mask = np.ones(c.rids.size, bool)
            fresh_mask[c.pre_idx] = False
            fresh_idx = np.where(fresh_mask)[0]
            self.executor.drop_source_copies(c.rids[c.pre_idx], c.src)
            fresh_payload = (
                self.executor.stage_cohort(c.rids[fresh_idx], c.src)
                if fresh_idx.size
                else None
            )
            payload = {}
            n = int(c.rids.size)
            pre_t = torch.as_tensor(c.pre_idx)
            fresh_t = torch.as_tensor(fresh_idx)
            for k in PAYLOAD_KEYS:
                ref = c.pre_payload[k]
                arr = torch.zeros((n,) + tuple(ref.shape[1:]), dtype=ref.dtype, device=ref.device)
                arr[pre_t] = ref
                if fresh_payload is not None:
                    arr[fresh_t] = torch.as_tensor(fresh_payload[k]).to(ref.device)
                payload[k] = arr
            c.pre_payload = None
            n_read = int(fresh_idx.size)
        else:
            payload = self.executor.stage_cohort(c.rids, c.src, c.dst)
            n_read = 0 if "class_rows" in payload else int(c.rids.size)
        if n_read:
            src_dev = self.queues[self.executor.device_of(c.src)]
            nb = self.executor.page_stored_bytes(c.src) * n_read
            src_dev.submit(nb, now=now, write=False, ops=n_read)
            if self.executor.device_of(c.src) != self.executor.device_of(0):
                self.demand_swapin_s += src_dev.device.batch_service_time_s(
                    nb, ops=n_read
                )
        if use_ring:
            c.ring_slots = slots
            c.meta = self._pack(payload, slots, c)
            c.payload = None
            if faulty_src is not None and faulty_src.next_staged_payload():
                # Injected in-transit corruption: flip one byte of the pinned
                # copy; the CRC (of the clean bytes) catches it at unpack.
                self.ring.buf[slots[0], 0] ^= 0xFF
                self.corruptions_injected += 1
        else:
            c.payload = payload
        c.phase = "staged"
        return True

    def _faulty_device(self, level: int):
        """The fault wrapper on ``level``'s device queue, or None."""
        dev = self.queues[self.executor.device_of(int(level))].device
        return dev if hasattr(dev, "next_stage_attempt") else None

    def _fault_backoff(self, c: _Cohort) -> bool:
        """Bounded retry with deterministic backoff (2, 4, 8 ticks); aborts
        once retries are exhausted. Returns the tick's progressed flag."""
        if c.retries >= MAX_STAGE_RETRIES:
            c.phase = "aborted"
            self.cohorts_aborted += 1
            return True
        c.retries += 1
        self.fault_retries += 1
        c.next_retry_tick = self._step + (1 << c.retries)
        return False

    @traced("pipeline.transcode")
    def _transcode(self, c: _Cohort) -> None:
        payload = self._unpack(c) if c.ring_slots is not None else c.payload
        payload = self.executor.transcode_cohort(payload, c.src, c.dst)
        if c.ring_slots is not None:
            c.meta = self._pack(payload, c.ring_slots, c)
        else:
            c.payload = payload
        c.phase = "transcoded"

    @traced("pipeline.commit")
    def _commit(self, c: _Cohort, now: float) -> None:
        payload = self._unpack(c) if c.ring_slots is not None else c.payload
        marker = "class_rows" in payload
        actual = np.asarray(self.executor.commit_cohort(c.rids, payload, c.src, c.dst),
                            np.int64)
        # Bill the devices that really absorbed the writes (spills included).
        for level in np.unique(actual):
            if marker and int(level) in (c.dst, c.src):
                continue  # table-edit landing: no bytes written
            n = int((actual == level).sum())
            self.queues[self.executor.device_of(int(level))].submit(
                self.executor.page_stored_bytes(int(level)) * n,
                now=now,
                write=True,
                ops=n,
            )
        if c.ring_slots is not None:
            self.ring.release(c.ring_slots)
            c.ring_slots = None
        c.payload = None
        c.crcs = None
        c.pristine = None
        c.phase = "committed"
        self.cohorts_done += 1
        self.pages_moved += int(c.rids.size)

    # ------------------------------------------------- speculative prefetch
    def submit_prefetch(self, cohorts: Sequence[Tuple[np.ndarray, int]]) -> int:
        """Queue speculative (rids, src) staging cohorts, chunked to the
        ring's reserved slice. No-op in serial mode."""
        if self.serial:
            return 0
        chunk = max(self.ring.spec_slots, 1)
        n = 0
        for rids, src in cohorts:
            rids = np.asarray(rids, np.int64)
            for lo in range(0, rids.size, chunk):
                part = rids[lo : lo + chunk]
                if part.size:
                    self._spec.append(
                        _Cohort(part, int(src), int(src), speculative=True)
                    )
                    n += int(part.size)
        return n

    def _tick_spec(self, now: float) -> bool:
        """Advance the oldest speculative cohort by one phase."""
        c = self._spec[0]
        if c.phase == "pending":
            slots = self.ring.try_acquire(int(c.rids.size), speculative=True)
            if slots is None:
                return False
            payload = self.executor.peek_cohort(c.rids, c.src)
            dev_name = self.executor.device_of(c.src)
            dev = self.queues[dev_name]
            nb = self.executor.page_stored_bytes(c.src) * int(c.rids.size)
            dev.submit(nb, now=now, write=False, ops=int(c.rids.size))
            svc = dev.device.batch_service_time_s(nb, ops=int(c.rids.size))
            self.prefetch_bytes += nb
            self.prefetch_busy_by_device[dev_name] = (
                self.prefetch_busy_by_device.get(dev_name, 0.0) + svc
            )
            c.ring_slots = slots
            c.meta = self._pack(payload, slots)
            c.phase = "staged"
            return True
        self._spec.popleft()
        dev = self.queues[self.executor.device_of(c.src)].device
        svc_page = dev.batch_service_time_s(self.executor.page_stored_bytes(c.src))
        for i, rid in enumerate(c.rids):
            self._held[int(rid)] = (c.src, c.ring_slots[i], c.meta, svc_page)
        self.prefetch_staged += int(c.rids.size)
        return True

    def finish_speculative(self) -> None:
        """Window boundary: run staged speculative cohorts to the held store;
        cohorts that never acquired credits are dropped."""
        budget = 4 * len(self._spec) + 8
        while self._spec:
            c = self._spec[0]
            if c.phase == "pending":
                self._spec.popleft()
                self.prefetch_cancelled += int(c.rids.size)
                continue
            budget -= 1
            if budget < 0:
                raise RuntimeError("speculative staging failed to finish")
            self._tick_spec(self._step * self.step_period_s)

    def claim_prefetched(
        self, rids: np.ndarray, src: int
    ) -> Dict[int, Dict[str, torch.Tensor]]:
        """Hand over held pages the boundary plan moves out of ``src``
        (rid -> raw source-codec row) and release their ring credits."""
        out: Dict[int, Dict[str, torch.Tensor]] = {}
        for rid in np.asarray(rids, np.int64):
            ent = self._held.get(int(rid))
            if ent is None or ent[0] != int(src):
                continue
            _, slot, meta, svc_page = self._held.pop(int(rid))
            out[int(rid)] = self._unpack_slot(slot, meta)
            self.ring.release([slot])
            dev_name = self.executor.device_of(int(src))
            self.prefetch_busy_by_device[dev_name] = (
                self.prefetch_busy_by_device.get(dev_name, 0.0) - svc_page
            )
            self.prefetch_hits += 1
        if out:
            self.tracer.count("prefetch.hits", len(out))
        return out

    def discard_speculative(self, rids=None, cancelled: bool = False) -> int:
        """Discard held prefetched pages (all when ``rids`` is None), returning
        their credits: boundary discards are misses, invalidations count as
        cancelled. The speculative read stays billed either way."""
        if rids is None:
            targets = list(self._held)
        else:
            targets = [int(r) for r in np.atleast_1d(np.asarray(rids, np.int64))]
        n = 0
        for rid in targets:
            ent = self._held.pop(rid, None)
            if ent is None:
                continue
            self.ring.release([ent[1]])
            n += 1
        if cancelled:
            self.prefetch_cancelled += n
            self.prefetch_invalidated += n
        else:
            self.prefetch_misses += n
            if n:
                self.tracer.count("prefetch.misses", n)
        # Invalidation also reaches queued speculative cohorts, so a recycled
        # rid can never claim a stale shadow copy.
        if rids is not None and self._spec:
            rset = set(targets)
            for c in list(self._spec):
                keep = np.array([int(r) not in rset for r in c.rids], bool)
                if keep.all():
                    continue
                if c.ring_slots is not None:
                    drop_slots = [s for s, k in zip(c.ring_slots, keep) if not k]
                    self.ring.release(drop_slots)
                    c.ring_slots = [s for s, k in zip(c.ring_slots, keep) if k]
                self.prefetch_cancelled += int((~keep).sum())
                c.rids = c.rids[keep]
                if c.rids.size == 0:
                    self._spec.remove(c)
        return n

    def holds_any(self, rids) -> bool:
        """Whether a demand cohort in the queue (pending or in flight) holds
        any of ``rids``."""
        rids = np.asarray(rids, np.int64)
        return any(np.isin(c.rids, rids).any() for c in self._queue)

    def speculative_rids(self) -> set:
        """Rids currently held or queued on the speculative path."""
        out = set(self._held)
        for c in self._spec:
            out.update(int(r) for r in c.rids)
        return out

    # ------------------------------------------------------- ring transit
    def _pack(self, payload, slots: List[int], cohort: Optional[_Cohort] = None) -> list:
        """Serialize each page's four arrays into its pinned ring slot (a
        blocking copy, so the arena holds the bytes when this returns). For a
        demand ``cohort``, record the per-slot CRC32 and the pristine rows."""
        rows, meta = _rows_of(payload)
        host = rows.to("cpu")
        self.ring.stage_rows(slots, host)
        if cohort is not None:
            cohort.crcs = [zlib.crc32(host[i].numpy()) for i in range(len(slots))]
            cohort.pristine = host
        return meta

    def _unpack_slot(self, slot: int, meta) -> Dict[str, torch.Tensor]:
        """Deserialize one page's four arrays out of its ring slot."""
        row = _split_rows(self.ring.view(slot)[None], meta)
        return {k: v[0] for k, v in row.items()}

    def _unpack(self, c: _Cohort) -> Dict[str, torch.Tensor]:
        """The cohort's payload read back out of the ring (host tensors),
        after checking every slot's CRC: a corrupted slot is counted and
        re-staged from the pristine rows (no media bytes move)."""
        assert c.meta is not None and c.ring_slots is not None
        for i, slot in enumerate(c.ring_slots):
            if c.crcs is not None and zlib.crc32(self.ring.view(slot).numpy()) != c.crcs[i]:
                self.corruptions_detected += 1
                self.ring.stage_rows([slot], c.pristine[i : i + 1])
                self.corruptions_repaired += 1
        idx = torch.as_tensor(c.ring_slots, dtype=torch.int64)
        n = int(self.ring._fill[c.ring_slots[0]])
        return _split_rows(self.ring.buf[idx, :n], c.meta)

    # ---------------------------------------------------------------- views
    def media_busy_s(self) -> Dict[str, float]:
        """Modeled busy seconds per device queue (the reference's media
        constants, not a time measured on any device)."""
        return {name: q.busy_s for name, q in self.queues.items()}

    def media_bytes(self) -> Dict[str, int]:
        return {name: q.bytes_total for name, q in self.queues.items()}

    def prefetch_hit_rate(self) -> float:
        """Hits / (hits + misses) over everything that reached the held
        store and met a window boundary."""
        denom = self.prefetch_hits + self.prefetch_misses
        return self.prefetch_hits / denom if denom else 0.0
