"""Tiered paged KV cache: device pools + host tiers + page tables, after
``repro.serving.kv_cache``.

  placement levels for a KV page (region):
    1 = warm  device pool, int8-HBM   (C5/C6-class tier: low latency)
    2 = cold  device pool, int4-HBM   (C9-class: denser, mid latency)
    3 = host  int8 behind PCIe        (C7-class)
    4 = host  int4 behind PCIe        (C10/C12-class: best TCO)

Storage is codec-class-major: device payloads live in one shared buffer per
codec class (``c8_*`` int8, ``c4_*`` int4) and page tables hold GLOBAL
class-buffer rows, so same-class migrations are pure table edits. The dense
recent window plays DRAM's role for the newest tokens. Pages in device pools
are read by every decode step through the fused attention kernel, which
returns exact per-page softmax mass (the hotness telemetry); host pages are
not read in-step but appear as sentinel rows (a per-page key centroid in
``state.host_summary``) whose would-have-touched mass is tracked separately.

All placement state is host-side numpy (daemon side); host-tier payloads are
numpy too. Device state is ``TieredKVState`` tensors: the page tables' source
is host arrays that hold each entry's region id beside it, edited in place
and uploaded to the device once per batch (the device copies are never read
back; the telemetry fold reads the host side), and the class buffers are
written in place (the reference's functional ``.at[].set``).
``manager.placement`` is the policy's desired placement, ``self.physical``
where each page's payload actually lives. Two executors reconcile them
cohort by cohort, with one ``transcode_pages`` launch per transcoding
cohort:

  * serial (``async_migration=False``, the equivalence oracle):
    ``migrate_batch`` runs the window's plan to completion at the boundary;
  * async (the default): the plan's cohorts go to the media pipeline
    (``media.pipeline.MigrationPipeline``), which drives the phase-split
    executor below (``stage_cohort`` / ``transcode_cohort`` /
    ``commit_cohort``) one phase per decode step, through the pinned
    staging ring for host-media cohorts. Cohorts between the device pools
    stay device tensors (the reference round-trips them through host
    numpy); every payload that reaches ``transcode_pages`` is on
    ``self.device``. Speculative prefetch stages warming host pages through
    the ring's reserved slice mid-window, and a ``FaultPlan`` injects
    deterministic media faults; final placements stay bit-identical to the
    serial executor's.

The per-page ``migrate`` path is the batched executor's oracle and serves
the single-page evictions of ``append_page``. Host sentinels' key centroids
and the per-page fetch dequantize through ``kops.dequant_pages`` on
``self.device`` (the CUDA kernel on a GPU), or, for HOST8 pages on the
``cxl_hw`` expander, through ``kops.cxl_decode_pages``. Preemption to the
host tier (``demote_slot_to_host`` / ``park_slot`` / ``restore_slot``)
lifts a slot's KV out of the cache as a ``ParkedSlot`` and swaps it back in
bit-exactly, into any free slot of a cache of the same geometry.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import codecs, tco
from repro_torch.core.manager import ManagerConfig, TierScapeManager
from repro_torch.core.pools import ClassPartition, SlotAllocator, exchange_slots
from repro_torch.core.tiers import TierSet, get as get_tier
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.media.devices import adaptive_devices, make_queues
from repro_torch.media.faults import FaultyMediaDevice
from repro_torch.media.pipeline import PAYLOAD_KEYS, MigrationPipeline
from repro_torch.media.ringbuf import PinnedRing
from repro_torch.runtime.serve import CLASS_FIELDS, TieredKVState, init_tiered_kv_state
from repro_torch.tracing import Tracer, traced

# Placement indices (0 stays "uncompressed DRAM" for cost-model parity with
# the paper; KV pages never occupy it — the recent window does).
WARM, COLD, HOST8, HOST4 = 1, 2, 3, 4
_DEVICE = (WARM, COLD)
_POOL = {WARM: "warm", COLD: "cold"}
_DEVICE_TIER_IDS = {
    ("warm", 8): "C5",  # SL-I8-HB
    ("warm", 4): "C8",  # SL-I4-HB
    ("cold", 8): "C6",  # PK-I8-HB
    ("cold", 4): "C9",  # PK-I4-HB
}
# A page staged out of its source tier but not yet committed by the async
# pipeline. Every placement mask is a positive-level comparison, so in-flight
# pages drop out of telemetry folds, eviction scans and capacity pre-passes.
INFLIGHT = -1
# The page table that holds a page at each placement level (1 warm, 2 cold,
# 3 host sentinels, 0 none), indexed by level: INFLIGHT (-1) reads the last 0.
_TABLE_OF_LEVEL = np.array([0, 1, 2, 3, 3, 0], np.int8)
_TABLE_CODE = {"warm": 1, "cold": 2, "host": 3}


def kv_tierset(
    page_elems: int, warm_bits: int = 8, cold_bits: int = 4, host_device: str = ""
) -> TierSet:
    """TierSet for a device-pool codec split: (C5, C9, C7, C10) by default
    (int8-HBM, int4-HBM, int8-host, int4-host); same-width splits pick the
    matching characterized tiers so byte/latency accounting follows the
    deployed codecs. ``host_device`` rebinds the two host tiers onto another
    media device of the catalog (e.g. ``"cxl_hw"``): payloads are unchanged,
    only media billing and service times move."""
    ids = (
        _DEVICE_TIER_IDS[("warm", int(warm_bits))],
        _DEVICE_TIER_IDS[("cold", int(cold_bits))],
        "C7",
        "C10",
    )
    ts = tuple(get_tier(t) for t in ids)
    if host_device:
        ts = ts[:2] + tuple(dataclasses.replace(t, media_device=host_device) for t in ts[2:])
    return TierSet(tiers=ts, block_elems=page_elems)


def _np(x) -> np.ndarray:
    """Host numpy view of a tensor (copied off the device) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class ParkedPage:
    """One preempted page lifted out of the region space: the exact stored
    host-tier bytes plus where to land it on resume."""

    layer: int
    page: int  # logical page index within the sequence
    host_level: int  # HOST8 | HOST4 — codec of the parked payload
    restore_level: int  # pre-preemption placement to swap back to on resume
    payload: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass
class ParkedSlot:
    """A preempted batch slot's full KV state, detached from the cache.

    ``park_slot`` produces one after ``demote_slot_to_host`` has pushed every
    device-resident page to its same-codec host tier (a raw media copy, no
    transcode, so payload bytes round-trip bit-exactly). Payloads are host
    numpy and the recent-window rows host tensors (copies, never views of a
    device buffer), so the parked request outlives its cache and restores
    into ANY free slot of ANY cache with the same geometry via
    ``restore_slot``; pages re-enter through the swap-in cohorts, billed like
    every other promotion."""

    tenant: int
    pages: List[ParkedPage]
    recent_k: torch.Tensor  # [L, R, KV, hd] host copy of the slot's recent window
    recent_v: torch.Tensor
    recent_len: int
    total_len: int


class _TableEditor:
    """The page tables' source of truth: host arrays of the warm, cold and
    host sentinel tables and counts, with each entry's region id (rid)
    beside it in a same-shaped array, -1 at and past each row's count (so a
    rid marks an entry below the count; the table itself keeps stale rows
    there). The cache is the tables' only writer: every migrate/append
    batch edits these arrays in place and ``commit`` uploads each table to
    the device once. The device copies are write-only; the telemetry fold
    reads the host tables and rids. ``classes`` names each device pool's
    codec-class buffer ("c8"/"c4"). A commit whose row check fails leaves
    its edits in the host arrays: the cache is not usable after it."""

    _POOLS = ("warm", "cold", "host")

    def __init__(self, state: TieredKVState, classes: Dict[str, str], batch_slots: int,
                 max_pages: int, tracer: Tracer):
        self.classes = classes
        self._bs, self._mp = batch_slots, max_pages
        self.tracer = tracer
        shape = {p: tuple(getattr(state, f"{p}_table").shape) for p in self._POOLS}
        self.tables = {p: np.zeros(shape[p], np.int32) for p in self._POOLS}
        self.counts = {p: np.zeros(shape[p][:2], np.int32) for p in self._POOLS}
        self.rids = {p: np.full(shape[p], -1, np.int64) for p in self._POOLS}

    def _rows(self, rids):
        rids = np.asarray(rids, np.int64)
        return rids // (self._bs * self._mp), (rids // self._mp) % self._bs

    def remove(self, pool: str, rids, pool_slots) -> None:
        """Drop each rid's entry (found by its pool row) from its (layer,
        slot) row: the row's last entry takes its place."""
        t, c, rr = self.tables[pool], self.counts[pool], self.rids[pool]
        layers, slots = self._rows(rids)
        for la, sl, ps in zip(layers, slots, pool_slots):
            n = int(c[la, sl])
            row, rrow = t[la, sl], rr[la, sl]
            idx = int(np.where(row[:n] == ps)[0][0])
            row[idx] = row[n - 1]
            rrow[idx] = rrow[n - 1]
            row[n - 1] = 0
            rrow[n - 1] = -1
            c[la, sl] = n - 1

    def insert(self, pool: str, rids, pool_slots) -> None:
        """Append each rid's pool row to the end of its (layer, slot) row."""
        t, c, rr = self.tables[pool], self.counts[pool], self.rids[pool]
        layers, slots = self._rows(rids)
        for r, la, sl, ps in zip(np.asarray(rids, np.int64), layers, slots, pool_slots):
            n = int(c[la, sl])
            t[la, sl, n] = ps
            rr[la, sl, n] = r
            c[la, sl] = n + 1

    def clear_slot(self, state: TieredKVState, slot: int, pools=_POOLS) -> None:
        """Zero one batch slot's counts in ``pools``, on the host and in place
        on the device (entries past a count are stale and never read)."""
        for p in pools:
            self.counts[p][:, slot] = 0
            self.rids[p][:, slot] = -1
            getattr(state, f"{p}_n")[:, slot] = 0

    def check_rows(self, state: TieredKVState) -> None:
        """Every valid entry of the edited tables must address a row of its
        class buffer (the host table: of the host summary); the attention
        kernels trust the tables. This is the decode step's class-bounds
        check (``kops._check_class_bounds``), made once per edit on the
        host tables instead of once per layer and step on the device."""
        for p in self._POOLS:
            if p == "host":
                cls, rows = "host summary", state.host_summary.shape[1]
            else:
                c = self.classes[p]
                cls, rows = ("int8" if c == "c8" else "int4"), getattr(state, f"{c}_k").shape[1]
            t, n = self.tables[p], self.counts[p]
            valid = t[np.arange(t.shape[-1]) < n[..., None]]
            if valid.size and (valid.min() < 0 or valid.max() >= rows):
                raise kops.class_rows_error(cls, int(valid.min()), int(valid.max()), int(rows))

    def commit(self, state: TieredKVState) -> TieredKVState:
        """Check the rows, then upload every table and count to the device
        (copies: the device tensors never alias the host arrays). Counted as
        ``cache.table_uploads``."""
        self.check_rows(state)
        dev = state.warm_table.device
        kw = {}
        for p in self._POOLS:
            kw[f"{p}_table"] = torch.tensor(self.tables[p], device=dev)
            kw[f"{p}_n"] = torch.tensor(self.counts[p], device=dev)
        self.tracer.count("cache.table_uploads")
        return dataclasses.replace(state, **kw)


class TieredKVCache:
    """Host-side controller for one attention-layer-group x batch of slots."""

    def __init__(
        self,
        cfg: ModelConfig,
        n_attn_layers: int,
        batch_slots: int,
        page_tokens: int,
        max_seq_len: int,
        recent_window: int,
        manager_cfg: ManagerConfig,
        warm_frac: float = 0.5,
        tenant_quota: Optional[Dict[str, Dict[int, int]]] = None,
        async_migration: bool = False,
        ring_slots: int = 64,
        media_step_s: float = 50e-6,
        prefetch: bool = False,
        prefetch_max_pages: int = 8,
        pool_bits: Optional[Dict[str, int]] = None,
        host_media_device: str = "",
        fault_plan=None,
        device="cuda",
        tracer: Optional[Tracer] = None,
    ):
        """``tenant_quota`` maps pool name ("warm"/"cold") -> {tenant id ->
        max concurrently held slots}; quota exhaustion spills that tenant's
        pages down-tier. ``async_migration`` routes window plans through the
        media pipeline instead of the blocking ``migrate_batch``;
        ``prefetch`` (async only) stages warming host pages speculatively
        through the ring's reserved slice, placements unchanged.
        ``pool_bits`` maps pool name -> codec width (8 or 4) for the device
        pools, default ``{"warm": 8, "cold": 4}``; pools of the same width
        share one codec-class buffer. ``host_media_device`` rebinds the host
        tiers onto another catalog device (e.g. ``"cxl_hw"``).
        ``fault_plan`` (a ``media.faults.FaultPlan``) wraps every media
        queue's device in a ``FaultyMediaDevice`` on one window clock.
        ``tracer`` takes the cache's and its pipeline's spans and counters
        (the engine's; a fresh one by default)."""
        self.device = resolve_device(device)
        self.tracer = tracer or Tracer()
        self.cfg = cfg
        self.la = n_attn_layers
        self.bs = batch_slots
        self.pt = page_tokens
        self.max_pages = max_seq_len // page_tokens
        self.recent_window = recent_window
        hd = cfg.head_dim_()
        kv = cfg.n_kv_heads
        self.page_elems = page_tokens * kv * hd * 2  # K and V
        total_pages = self.la * self.bs * self.max_pages
        warm_cap = max(int(total_pages * warm_frac), 8)
        cold_cap = max(total_pages, 8)

        pool_bits = dict(pool_bits or {})
        wb = int(pool_bits.get("warm", 8))
        cb = int(pool_bits.get("cold", 4))
        if wb not in (8, 4) or cb not in (8, 4):
            raise ValueError(f"pool_bits must be 8 or 4, got warm={wb} cold={cb}")
        self._cls = {"warm": "c8" if wb == 8 else "c4", "cold": "c8" if cb == 8 else "c4"}
        self._bits = {WARM: wb, COLD: cb, HOST8: 8, HOST4: 4}
        part = ClassPartition([("warm", wb, warm_cap), ("cold", cb, cold_cap)])

        # Every layer's class buffer holds rows for ALL layers' pages (the
        # reference layout, kept for row-for-row parity): an n_attn_layers-
        # fold over-allocation of the device pools.
        self.state = init_tiered_kv_state(
            cfg,
            batch_slots,
            page_tokens=page_tokens,
            warm_pages=warm_cap,
            cold_pages=cold_cap,
            max_pages_per_seq=self.max_pages,
            recent_window=recent_window,
            n_attn_layers=n_attn_layers,
            host_slots=self.bs * self.max_pages,
            warm_bits=wb,
            cold_bits=cb,
            device=self.device,
        )
        # The page tables' source: host arrays, each entry beside its rid.
        self._tables = _TableEditor(self.state, self._cls, self.bs, self.max_pages, self.tracer)
        # Host tier pools: region id -> (k_pay, k_sc, v_pay, v_sc) numpy.
        self.host_pages: Dict[int, Tuple[np.ndarray, ...]] = {}

        # Region space: (layer, slot, page) flattened.
        self.n_regions = total_pages
        self.host_media_device = str(host_media_device)
        self.manager = TierScapeManager(
            kv_tierset(self.page_elems, wb, cb, host_device=self.host_media_device),
            self.n_regions,
            region_bytes=self.page_elems * 2,
            cfg=manager_cfg,
        )
        self._page_exists = np.zeros(self.n_regions, bool)
        # Where the payload actually lives (manager.placement is the desired
        # placement the policy computed; the executor reconciles them).
        self.physical = np.zeros(self.n_regions, np.int64)
        tenant_quota = tenant_quota or {}
        self._alloc = {
            "warm": SlotAllocator(warm_cap, tenant_quota.get("warm"), base=part.base("warm")),
            "cold": SlotAllocator(cold_cap, tenant_quota.get("cold"), base=part.base("cold")),
        }
        # Host sentinel summary slots: per-layer free lists (a layer hosts at
        # most bs*max_pages pages), so allocation never fails.
        self._host_alloc = [SlotAllocator(self.bs * self.max_pages) for _ in range(self.la)]
        self._pool_slot = np.full(self.n_regions, -1, np.int64)
        self._host_slot = np.full(self.n_regions, -1, np.int64)
        self.slot_tenant = np.zeros(self.bs, np.int64)
        self._rid_slot = (np.arange(self.n_regions) // self.max_pages) % self.bs
        # Compute-kernel dispatches of the ingestion/migration path
        # (quant / dequant / transcode — the daemon-tax proxy).
        self.kernel_dispatches = 0
        # Decode-side attention launches billed per step by
        # ``kops.decode_launches_per_step`` (1 per layer on the fused path).
        self.attn_launches = 0

        # --- backing-media subsystem: one MediaQueue per distinct device, a
        # staging ring sized for the fattest page (int8 payload + f32
        # scales, K and V), pinned on a GPU, and the migration pipeline
        # (serial=True keeps the blocking boundary, the oracle).
        ts = self.manager.tierset
        self._dev_names = [d.name for d in ts.media_devices()]
        self._page_stored_bytes = np.array(
            [self.page_elems * 2] + [t.stored_bytes(self.page_elems, 2) for t in ts.tiers],
            np.int64,
        )
        hd8 = page_tokens * kv * hd  # int8 payload bytes per K (or V) page
        sc = 4 * page_tokens * kv  # f32 scale bytes per K (or V) page
        self.staging_ring = PinnedRing(max(ring_slots, 2), 2 * (hd8 + sc),
                                       pin=self.device.type == "cuda")
        self.media_queues = make_queues(self._dev_names)
        self.fault_plan = fault_plan
        self._fault_window = 0
        self._down_devices: set = set()
        self.fault_deferred_pages = 0  # plan entries deferred off down devices
        self._spill_depth = 0  # nested commit-spill depth (redirect guard)
        self._fault_counter_snapshot = (0, 0, 0)
        if fault_plan is not None:
            for q in self.media_queues.values():
                q.device = FaultyMediaDevice(q.device, fault_plan)
        self.async_migration = async_migration
        self.pipeline = MigrationPipeline(
            self, self.staging_ring, self.media_queues,
            step_period_s=media_step_s, serial=not async_migration, tracer=self.tracer,
        )
        self._pending_reconcile: List[np.ndarray] = []
        self._media_busy_snapshot: Dict[str, float] = {}
        # Prefetch needs mid-window decode steps to hide the read behind:
        # async only, at most one cohort emission per profile window.
        self.prefetch_enabled = bool(prefetch and async_migration)
        self.prefetch_max_pages = prefetch_max_pages
        self._prefetch_window_emitted = False

    # ------------------------------------------------------------- helpers
    def rid(self, layer: int, slot: int, page: int) -> int:
        return (layer * self.bs + slot) * self.max_pages + page

    def _ix(self, a) -> torch.Tensor:
        """Index tensor on the cache's device."""
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    # ---------------------------------------------------------- multi-tenant
    def set_slot_tenant(self, slot: int, tenant: int) -> None:
        """Tag a batch slot (and all pages it will hold) with a tenant id."""
        self.slot_tenant[slot] = tenant

    def tenant_mask(self, tenant: int) -> np.ndarray:
        """(n_regions,) bool: regions owned by ``tenant`` via their slot."""
        return self.slot_tenant[self._rid_slot] == tenant

    # ------------------------------------------------- pool slot accounting
    @property
    def _free_warm(self) -> List[int]:
        return self._alloc["warm"]._free

    @property
    def _free_cold(self) -> List[int]:
        return self._alloc["cold"]._free

    def _tenant_of_rid(self, rid: int) -> int:
        return int(self.slot_tenant[int(self._rid_slot[rid])])

    def _quota_headroom(self, pool: str, tenant: int) -> int:
        """Slots ``tenant`` may still claim under its quota alone."""
        a = self._alloc[pool]
        if a.tenant_quota is None:
            return a.capacity
        if tenant not in a.tenant_quota:
            raise KeyError(
                f"tenant {tenant!r} allocates from quota'd pool {pool!r} "
                f"but has no quota entry"
            )
        return max(a.tenant_quota[tenant] - a.used_by(tenant), 0)

    def _pool_headroom(self, pool: str, tenant: Optional[int] = None) -> int:
        """Slots allocatable right now: global free list, clipped by the
        tenant's quota when the pool is quota-managed."""
        a = self._alloc[pool]
        free = len(a._free)
        if a.tenant_quota is None or tenant is None:
            return free
        return min(free, self._quota_headroom(pool, tenant))

    def _alloc_slot(self, pool: str, rid: int) -> int:
        a = self._alloc[pool]
        tenant = self._tenant_of_rid(rid) if a.tenant_quota is not None else None
        return a.alloc(int(rid), tenant)

    def _free_slot(self, pool: str, pool_slot: int) -> None:
        self._alloc[pool].free(int(pool_slot))

    def _commit_tables(self) -> None:
        self.state = self._tables.commit(self.state)

    # ------------------------------------------------ class-major addressing
    def _same_class(self, src: int, dst: int) -> bool:
        """Device->device move within one codec class: payload bytes stay in
        place in the shared class buffer; only row ownership moves."""
        return src in _DEVICE and dst in _DEVICE and self._bits[src] == self._bits[dst]

    def _gather_rows(self, pool: str, layers, ps):
        """Gather a pool cohort's payload/scale rows from its class buffer."""
        st = self.state
        cls = self._cls[pool]
        li, pi = self._ix(layers), self._ix(ps)
        return tuple(getattr(st, f"{cls}_{f}")[li, pi] for f in CLASS_FIELDS)

    def _scatter_rows(self, pool: str, layers, ps, k_pay, k_sc, v_pay, v_sc) -> None:
        """Write a cohort's rows into its class buffer (in place)."""
        st = self.state
        cls = self._cls[pool]
        li, pi = self._ix(layers), self._ix(ps)
        for f, val in zip(CLASS_FIELDS, (k_pay, k_sc, v_pay, v_sc)):
            buf = getattr(st, f"{cls}_{f}")
            buf[li, pi] = torch.as_tensor(val, device=self.device).to(buf.dtype)

    def _exchange_rows(self, src: int, dst: int, rids, ps) -> None:
        """Transfer class-row ownership for a same-class cohort (dst tenant
        quota enforced like alloc). ``_pool_slot`` is untouched."""
        sa, da = self._alloc[_POOL[src]], self._alloc[_POOL[dst]]
        for r, x in zip(rids, ps):
            tenant = (
                self._tenant_of_rid(int(r)) if da.tenant_quota is not None else None
            )
            exchange_slots(sa, da, int(x), int(r), tenant)

    def _set_placement(self, rids, level) -> None:
        self.physical[rids] = level
        self.manager.placement[rids] = level

    def _invalidate_prefetch(self, rids) -> None:
        """A host page moved or was freed under its speculative shadow copy:
        the staged bytes are stale and must never be claimed. Ring credits
        return; counts as cancelled."""
        if self.prefetch_enabled:
            self.pipeline.discard_speculative(rids, cancelled=True)

    # ------------------------------------------------- host sentinel rows
    # Every page on a host tier carries a sentinel: its key centroid (mean
    # over the page's T tokens of the dequantized stored K payload) in
    # ``state.host_summary`` plus a ``host_table`` entry.
    def _host_sentinel_insert(self, rids, layers, k_pay, k_sc, level: int,
                              commit: bool = True) -> None:
        rids = np.asarray(rids, np.int64)
        if rids.size == 0:
            return
        # One decode launch on the cache's device (f32 out, bit-equal to the
        # plain version), then the reference's numpy f32 mean over tokens.
        self.kernel_dispatches += 1
        deq = self._decode_pages(
            torch.as_tensor(k_pay, device=self.device),
            torch.as_tensor(k_sc, device=self.device), level,
        )
        summ = _np(deq).mean(axis=1)  # [P, KV, hd]
        hs = np.array(
            [self._host_alloc[int(la)].alloc(int(r)) for la, r in zip(layers, rids)],
            np.int64,
        )
        self.state.host_summary[self._ix(layers), self._ix(hs)] = torch.as_tensor(
            summ, device=self.device
        )
        self._host_slot[rids] = hs
        self._tables.insert("host", rids, hs)
        if commit:
            self._commit_tables()

    def _host_sentinel_remove(self, rids, layers, commit: bool = True) -> None:
        rids = np.asarray(rids, np.int64)
        if rids.size == 0:
            return
        hs = self._host_slot[rids]
        self._tables.remove("host", rids, hs)
        if commit:
            self._commit_tables()
        for la, x in zip(layers, hs):
            self._host_alloc[int(la)].free(int(x))
        self._host_slot[rids] = -1

    # -------------------------------------------------- page ingestion path
    def append_pages(self, entries: Sequence[Tuple[int, int, int]], kpages, vpages) -> None:
        """Batched ingestion: quantize all N new pages with one kernel
        launch per destination tier (K and V stacked into one batch) and
        commit the page tables once. ``entries`` is [(layer, slot, page)];
        kpages/vpages are [N, T, KV, hd] f32 or bf16 tensors (the engine
        hands over the KV cache's bf16; quantization upcasts exactly)."""
        n = len(entries)
        if n == 0:
            return
        rids = np.array([self.rid(*e) for e in entries], np.int64)
        layers = np.array([e[0] for e in entries], np.int64)
        slots = np.array([e[1] for e in entries], np.int64)
        tenants = self.slot_tenant[slots]

        deficit = n - len(self._free_warm)
        if deficit > 0:
            # Warm pressure: demote the coldest existing warm pages, batched.
            hot = self.manager.telemetry.averaged_hotness(2)
            cand = np.where((self.physical == WARM) & self._page_exists)[0]
            take = cand[np.argsort(hot[cand])][:deficit]
            if take.size:
                self.migrate_batch(take, np.full(take.size, COLD, np.int64))
        if self._alloc["warm"].tenant_quota is not None:
            # Per-tenant pressure: a tenant at quota frees headroom only by
            # demoting its OWN coldest warm pages.
            hot = self.manager.telemetry.averaged_hotness(2)
            for t in np.unique(tenants):
                want = int((tenants == t).sum())
                q_deficit = want - self._quota_headroom("warm", int(t))
                if q_deficit <= 0:
                    continue
                cand = np.where(
                    (self.physical == WARM) & self._page_exists & self.tenant_mask(int(t))
                )[0]
                take = cand[np.argsort(hot[cand])][:q_deficit]
                if take.size:
                    self.migrate_batch(take, np.full(take.size, COLD, np.int64))

        # Per-entry destination: warm while global + tenant headroom lasts,
        # then cold, then (cold quota exhausted) the int4 host tier.
        dst_of = np.full(n, HOST4, np.int64)
        warm_fit = self._claim_fits("warm", rids)
        dst_of[warm_fit] = WARM
        rest = np.where(~warm_fit)[0]
        if rest.size:
            cold_fit = self._claim_fits("cold", rids[rest])
            dst_of[rest[cold_fit]] = COLD

        for dst in (WARM, COLD, HOST4):
            sel = np.where(dst_of == dst)[0]
            if sel.size == 0:
                continue
            p = sel.size
            bits = self._bits[dst]
            si = self._ix(sel)
            pay, sc = kops.quant_pages(torch.cat([kpages[si], vpages[si]]), bits)
            self.kernel_dispatches += 1
            if dst in _DEVICE:
                self._scatter_device(
                    dst, rids[sel], layers[sel], pay[:p], sc[:p], pay[p:], sc[p:]
                )
            else:
                kp, ks = _np(pay[:p]), _np(sc[:p])
                vp, vs = _np(pay[p:]), _np(sc[p:])
                for j, r in enumerate(rids[sel]):
                    self.host_pages[int(r)] = (kp[j], ks[j], vp[j], vs[j])
                self._pool_slot[rids[sel]] = -2
                self._set_placement(rids[sel], dst)
                self._host_sentinel_insert(rids[sel], layers[sel], kp, ks, dst, commit=False)
            if dst == WARM:
                kp_sz = int(pay[:p].numel())
                sc_sz = int(sc[:p].numel())
                for _ in range(p):
                    self.manager.update_measured_ratio(
                        WARM, 2.0 * (kp_sz / p) / (kp_sz / p + 4 * sc_sz / p)
                    )
        self._commit_tables()
        self._page_exists[rids] = True

    def append_page(self, layer: int, slot: int, page: int, kpage, vpage) -> None:
        """Single-page ingestion (the batched path is ``append_pages``): the
        page exits the recent window into the warm tier, demoting the
        coldest warm page under pressure, and falls through to the cold tier
        when nothing is demotable. kpage/vpage are [T, KV, hd] float."""
        rid = self.rid(layer, slot, page)
        tenant = self._tenant_of_rid(rid)
        if self._pool_headroom("warm", tenant) == 0:
            # Under a pure quota shortage only this tenant's own warm pages
            # free quota; under global pressure any warm page will do.
            scoped = tenant if self._quota_headroom("warm", tenant) == 0 else None
            self._evict_coldest_warm(tenant=scoped)
        if self._pool_headroom("warm", tenant) == 0:
            self._page_exists[rid] = True
            self._insert(rid, layer, slot, page, kpage, vpage, COLD)
            return
        ps = self._alloc_slot("warm", rid)
        kp, ks, vp, vs = self._quant_page(kpage, vpage, self._bits[WARM])
        self._scatter_rows("warm", layer, ps, kp, ks, vp, vs)
        self._pool_slot[rid] = ps
        self._tables.insert("warm", [rid], [ps])
        self._commit_tables()
        self._set_placement(rid, WARM)
        self._page_exists[rid] = True
        self.manager.update_measured_ratio(
            WARM, 2.0 * kp.numel() / (kp.numel() + 4 * ks.numel()) * 1.0
        )

    def _evict_coldest_warm(self, tenant: Optional[int] = None) -> bool:
        """Warm pool pressure: demote the coldest warm page to the cold pool
        (per-page path). ``tenant`` scopes the victim search to one tenant's
        pages. Returns False when there is nothing demotable."""
        hot = self.manager.telemetry.averaged_hotness(2)
        mask = (self.physical == WARM) & self._page_exists
        if tenant is not None:
            mask &= self.tenant_mask(tenant)
        warm_rids = np.where(mask)[0]
        if warm_rids.size == 0:
            return False
        victim = warm_rids[np.argmin(hot[warm_rids])]
        self.migrate(int(victim), COLD)
        return True

    # ------------------------------------------------- batched migration
    def plan_cohorts(
        self, rids: np.ndarray, dsts: np.ndarray
    ) -> List[Tuple[np.ndarray, int, int]]:
        """Normalize a migration batch into ordered (rids, src, dst) cohorts.

        Dedups (last entry wins), drops no-ops/missing/in-flight pages, runs
        the warm capacity + tenant-quota pre-passes, and phase-orders the
        cohorts so frees land before re-claims: device->host swap-outs
        first, then warm->cold demotions, cold->warm promotions, host->device
        swap-ins, and finally host<->host retranscodes."""
        rids = np.asarray(rids, np.int64)
        dsts = np.asarray(dsts, np.int64)
        if rids.size and np.unique(rids).size != rids.size:
            _, rev_first = np.unique(rids[::-1], return_index=True)
            idx = np.sort(rids.size - 1 - rev_first)
            rids, dsts = rids[idx], dsts[idx]
        keep = (
            self._page_exists[rids]
            & (self.physical[rids] != dsts)
            & (self.physical[rids] != INFLIGHT)
        )
        rids, dsts = rids[keep], dsts[keep]
        if rids.size == 0:
            return []
        srcs = self.physical[rids].copy()

        # Warm-capacity pre-pass.
        inflow = int((dsts == WARM).sum())
        freed = int((srcs == WARM).sum())
        deficit = inflow - (len(self._free_warm) + freed)
        if deficit > 0:
            hot = self.manager.telemetry.averaged_hotness(2)
            in_batch = np.zeros(self.n_regions, bool)
            in_batch[rids] = True
            cand = np.where((self.physical == WARM) & self._page_exists & ~in_batch)[0]
            take = cand[np.argsort(hot[cand])][:deficit]
            if take.size:
                rids = np.concatenate([take, rids])
                srcs = np.concatenate([np.full(take.size, WARM, np.int64), srcs])
                dsts = np.concatenate([np.full(take.size, COLD, np.int64), dsts])
                deficit -= take.size
            if deficit > 0:
                # Still short: the coldest warm-bound pages spill to cold.
                warm_bound = np.where(dsts == WARM)[0]
                spill = warm_bound[np.argsort(hot[rids[warm_bound]])][:deficit]
                dsts[spill] = COLD
                still = dsts != srcs
                rids, srcs, dsts = rids[still], srcs[still], dsts[still]
        rids, srcs, dsts = self._quota_pre_pass(rids, srcs, dsts)
        if rids.size == 0:
            return []

        def phase(s: int, d: int) -> int:
            if s in _DEVICE and d not in _DEVICE:
                return 0  # device -> host: frees pool slots first
            if s == WARM and d == COLD:
                return 1
            if s == COLD and d == WARM:
                return 2
            if s not in _DEVICE and d in _DEVICE:
                return 3  # host -> device swap-in (through the pools)
            return 4  # host <-> host retranscode

        pairs = sorted(
            {(int(s), int(d)) for s, d in zip(srcs, dsts)},
            key=lambda p: (phase(*p), p),
        )
        return [
            (rids[(srcs == s) & (dsts == d)], s, d) for s, d in pairs
        ]

    def _quota_pre_pass(self, rids, srcs, dsts):
        """Tenant-quota capacity pre-pass for the device pools.

        Warm: a tenant whose warm inflow exceeds its remaining quota (plus
        its own in-batch warm frees) first demotes its own coldest
        non-batch warm pages, then spills its coldest warm-bound pages to
        the cold pool. Cold: overflow past the tenant's cold quota (after
        in-batch cold frees) spills straight to the int4 host tier."""
        if self._alloc["warm"].tenant_quota is not None and (dsts == WARM).any():
            hot = self.manager.telemetry.averaged_hotness(2)
            tenants_r = self.slot_tenant[self._rid_slot[rids]]
            for t in np.unique(tenants_r[dsts == WARM]):
                t = int(t)
                mine = tenants_r == t
                inflow = int(((dsts == WARM) & mine).sum())
                freed = int(((srcs == WARM) & mine).sum())
                deficit = inflow - (self._quota_headroom("warm", t) + freed)
                if deficit <= 0:
                    continue
                in_batch = np.zeros(self.n_regions, bool)
                in_batch[rids] = True
                cand = np.where(
                    (self.physical == WARM)
                    & self._page_exists
                    & self.tenant_mask(t)
                    & ~in_batch
                )[0]
                take = cand[np.argsort(hot[cand])][:deficit]
                if take.size:
                    rids = np.concatenate([take, rids])
                    srcs = np.concatenate([np.full(take.size, WARM, np.int64), srcs])
                    dsts = np.concatenate([np.full(take.size, COLD, np.int64), dsts])
                    tenants_r = self.slot_tenant[self._rid_slot[rids]]
                    deficit -= take.size
                if deficit > 0:
                    mine = tenants_r == t
                    warm_bound = np.where((dsts == WARM) & mine)[0]
                    spill = warm_bound[np.argsort(hot[rids[warm_bound]])][:deficit]
                    dsts[spill] = COLD
                    still = dsts != srcs
                    rids, srcs, dsts = rids[still], srcs[still], dsts[still]
                    tenants_r = self.slot_tenant[self._rid_slot[rids]]
        if self._alloc["cold"].tenant_quota is not None and (dsts == COLD).any():
            hot = self.manager.telemetry.averaged_hotness(2)
            tenants_r = self.slot_tenant[self._rid_slot[rids]]
            for t in np.unique(tenants_r[dsts == COLD]):
                t = int(t)
                mine = tenants_r == t
                inflow = int(((dsts == COLD) & mine).sum())
                freed = int(((srcs == COLD) & mine).sum())
                deficit = inflow - (self._quota_headroom("cold", t) + freed)
                if deficit <= 0:
                    continue
                cold_bound = np.where((dsts == COLD) & mine)[0]
                spill = cold_bound[np.argsort(hot[rids[cold_bound]])][:deficit]
                dsts[spill] = HOST4
                still = dsts != srcs
                rids, srcs, dsts = rids[still], srcs[still], dsts[still]
                tenants_r = self.slot_tenant[self._rid_slot[rids]]
        return rids, srcs, dsts

    def migrate_batch(self, rids: np.ndarray, dsts: np.ndarray) -> int:
        """Execute a migration batch cohort by cohort, blocking. When
        promotions would overflow the warm pool even after in-batch frees,
        the coldest non-batch warm pages are demoted first; any remaining
        overflow lands in the cold pool. Returns pages actually moved."""
        cohorts = self.plan_cohorts(rids, dsts)
        if not cohorts:
            return 0
        moved = 0
        for crids, s, d in cohorts:
            self._exec_cohort(crids, s, d)
            moved += int(crids.size)
        self._commit_tables()
        return moved

    def _exec_cohort(self, rids: np.ndarray, src: int, dst: int) -> None:
        """Move one (src, dst) cohort: gather -> (transcode | copy) ->
        scatter, editing the host tables (the caller commits). Same-class
        device moves only transfer row ownership and re-point the page
        tables — zero payload bytes move."""
        p = rids.size
        layers = rids // (self.bs * self.max_pages)

        if self._same_class(src, dst):
            ps = self._pool_slot[rids]
            self._tables.remove(_POOL[src], rids, ps)
            self._exchange_rows(src, dst, rids, ps)
            self._tables.insert(_POOL[dst], rids, ps)
            self._set_placement(rids, dst)
            return

        # Gather the cohort (K pages then V pages, so one kernel launch
        # covers both).
        if src in _DEVICE:
            pool = _POOL[src]
            ps = self._pool_slot[rids]
            k_pay, k_sc, v_pay, v_sc = self._gather_rows(pool, layers, ps)
            self._tables.remove(pool, rids, ps)
            for x in ps:
                self._free_slot(pool, int(x))
        else:
            self._invalidate_prefetch(rids)
            self._host_sentinel_remove(rids, layers, commit=False)
            hp = [self.host_pages.pop(int(r)) for r in rids]
            k_pay, k_sc, v_pay, v_sc = (
                torch.as_tensor(np.stack([h[i] for h in hp]), device=self.device)
                for i in range(4)
            )

        if self._bits[src] != self._bits[dst]:
            pay, sc = kops.transcode_pages(
                torch.cat([k_pay, v_pay]), torch.cat([k_sc, v_sc]),
                self._bits[src], self._bits[dst],
            )
            self.kernel_dispatches += 1
            k_pay, v_pay = pay[:p], pay[p:]
            k_sc, v_sc = sc[:p], sc[p:]
        # else: same-codec fast path — raw copy, no transcode launch.

        if dst in _DEVICE:
            self._scatter_device(dst, rids, layers, k_pay, k_sc, v_pay, v_sc)
        else:
            kp, ks = _np(k_pay), _np(k_sc)
            vp, vs = _np(v_pay), _np(v_sc)
            for i, r in enumerate(rids):
                self.host_pages[int(r)] = (kp[i], ks[i], vp[i], vs[i])
            self._pool_slot[rids] = -2
            self._set_placement(rids, dst)
            self._host_sentinel_insert(rids, layers, kp, ks, dst, commit=False)

    def _scatter_device(self, dst, rids, layers, k_pay, k_sc, v_pay, v_sc):
        """Claim pool rows for a cohort, write its payloads there and append
        the rows to the host tables (the caller commits)."""
        pool = _POOL[dst]
        new_ps = np.array([self._alloc_slot(pool, int(r)) for r in rids], np.int64)
        self._scatter_rows(pool, layers, new_ps, k_pay, k_sc, v_pay, v_sc)
        self._tables.insert(pool, rids, new_ps)
        self._pool_slot[rids] = new_ps
        self._set_placement(rids, dst)

    def _claim_fits(self, pool: str, rids: np.ndarray) -> np.ndarray:
        """Greedy in-order claim check: True where the rid could take a
        ``pool`` slot right now, honoring both the global free list and the
        rid's tenant quota."""
        a = self._alloc[pool]
        glob = len(a._free)
        claimed: Dict[int, int] = {}
        out = np.zeros(len(rids), bool)
        for i, r in enumerate(rids):
            t = self._tenant_of_rid(int(r))
            c = claimed.get(t, 0)
            if glob > 0 and self._pool_headroom(pool, t) - c > 0:
                out[i] = True
                claimed[t] = c + 1
                glob -= 1
        return out

    # ------------------------------------- phase-split executor (pipeline)
    # The async media pipeline drives one cohort through these callbacks
    # across successive decode steps. Payloads are dicts of tensors: rows
    # gathered from the class buffers stay on the device, host-tier rows are
    # host tensors; the pipeline serializes host-media cohorts through the
    # pinned ring bit-exactly.
    @staticmethod
    def _host_payload(hp) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.stack([h[i] for h in hp]))
                for i, k in enumerate(PAYLOAD_KEYS)}

    def stage_cohort(
        self, rids: np.ndarray, src: int, dst: Optional[int] = None
    ) -> Dict[str, torch.Tensor]:
        """Phase 1: gather the cohort's payloads and retire them from the
        source tier. Pages go in flight (out of every placement mask, and
        unread by decode steps) until ``commit_cohort`` lands them. For a
        move within one codec class the payload rows stay where they are and
        a ``class_rows`` marker rides the pipeline instead of bytes."""
        rids = np.asarray(rids, np.int64)
        layers = rids // (self.bs * self.max_pages)
        if dst is not None and self._same_class(src, dst):
            ps = self._pool_slot[rids]
            self._tables.remove(_POOL[src], rids, ps)
            self._commit_tables()
            # Rows stay owned by src's allocator until commit exchanges them.
            self.physical[rids] = INFLIGHT
            return {"class_rows": ps.copy()}
        if src in _DEVICE:
            pool = _POOL[src]
            ps = self._pool_slot[rids]
            payload = dict(zip(PAYLOAD_KEYS, self._gather_rows(pool, layers, ps)))
            self._tables.remove(pool, rids, ps)
            self._commit_tables()
            for x in ps:
                self._free_slot(pool, int(x))
        else:
            self._invalidate_prefetch(rids)
            self._host_sentinel_remove(rids, layers)
            payload = self._host_payload([self.host_pages.pop(int(r)) for r in rids])
        self.physical[rids] = INFLIGHT
        self._pool_slot[rids] = -3
        return payload

    def peek_cohort(self, rids: np.ndarray, src: int) -> Dict[str, torch.Tensor]:
        """Non-destructive gather for speculative staging (host tiers only):
        the source copy stays resident and readable."""
        if src in _DEVICE:
            raise ValueError("prefetch sources are host tiers")
        return self._host_payload([self.host_pages[int(r)] for r in np.asarray(rids, np.int64)])

    def drop_source_copies(self, rids: np.ndarray, src: int) -> None:
        """Retire the source copies of prefetched pages at commit time: their
        shadow copy replaces the boundary's source read."""
        if src in _DEVICE:
            raise ValueError("prefetch sources are host tiers")
        rids = np.asarray(rids, np.int64)
        self._host_sentinel_remove(rids, rids // (self.bs * self.max_pages))
        for r in rids:
            self.host_pages.pop(int(r), None)
        self.physical[rids] = INFLIGHT
        self._pool_slot[rids] = -3

    def transcode_cohort(
        self, payload: Dict[str, torch.Tensor], src: int, dst: int
    ) -> Dict[str, torch.Tensor]:
        """Phase 2: one ``transcode_pages`` launch for the whole cohort (K
        and V stacked) on the cache's device; the same-codec fast path and a
        ``class_rows`` marker pass through untouched."""
        if "class_rows" in payload or self._bits[src] == self._bits[dst]:
            return payload
        p = int(payload["k_pay"].shape[0])
        d = {k: torch.as_tensor(payload[k], device=self.device) for k in PAYLOAD_KEYS}
        pay, sc = kops.transcode_pages(
            torch.cat([d["k_pay"], d["v_pay"]]), torch.cat([d["k_sc"], d["v_sc"]]),
            self._bits[src], self._bits[dst],
        )
        self.kernel_dispatches += 1
        return {"k_pay": pay[:p], "k_sc": sc[:p], "v_pay": pay[p:], "v_sc": sc[p:]}

    def commit_cohort(
        self, rids: np.ndarray, payload: Dict[str, torch.Tensor], src: int, dst: int
    ) -> np.ndarray:
        """Phase 3: scatter into the destination tier. Device headroom is
        re-checked (appends may have raced the cohort); pages that no longer
        fit spill down-tier, re-transcoding when the spill crosses codecs.
        Returns the per-rid level actually landed."""
        rids = np.asarray(rids, np.int64)
        if "class_rows" in payload:
            return self._commit_class_rows(rids, payload["class_rows"], src, dst)
        actual = np.full(rids.size, dst, np.int64)
        if dst in _DEVICE:
            fits = self._claim_fits(_POOL[dst], rids)
            fi = np.where(fits)[0]
            if fi.size:
                frids = rids[fi]
                sel = torch.as_tensor(fi)
                self._scatter_device(
                    dst, frids, frids // (self.bs * self.max_pages),
                    *(payload[k][sel.to(payload[k].device)] for k in PAYLOAD_KEYS),
                )
                self._commit_tables()
            sp = np.where(~fits)[0]
            if sp.size:
                sel = torch.as_tensor(sp)
                sub = {k: v[sel.to(v.device)] for k, v in payload.items()}
                spill_dst = self._spill_target(dst)
                sub = self.transcode_cohort(sub, dst, spill_dst)
                self._spill_depth += 1
                try:
                    actual[sp] = self.commit_cohort(rids[sp], sub, src, spill_dst)
                finally:
                    self._spill_depth -= 1
            return actual
        kp, ks, vp, vs = (_np(payload[k]) for k in PAYLOAD_KEYS)
        for i, r in enumerate(rids):
            self.host_pages[int(r)] = (kp[i], ks[i], vp[i], vs[i])
        self._pool_slot[rids] = -2
        self._set_placement(rids, dst)
        self._host_sentinel_insert(rids, rids // (self.bs * self.max_pages), kp, ks, dst)
        return actual

    def _commit_class_rows(
        self, rids: np.ndarray, ps: np.ndarray, src: int, dst: int
    ) -> np.ndarray:
        """Commit a same-class marker cohort: exchange row ownership into the
        destination pool and re-point the tables (no payload motion). Pages
        that no longer fit fall back to the byte-moving path and spill."""
        ps = np.asarray(ps, np.int64)
        actual = np.full(rids.size, dst, np.int64)
        fits = self._claim_fits(_POOL[dst], rids)
        fi = np.where(fits)[0]
        if fi.size:
            frids, fps = rids[fi], ps[fi]
            self._exchange_rows(src, dst, frids, fps)
            self._tables.insert(_POOL[dst], frids, fps)
            self._commit_tables()
            self._set_placement(frids, dst)
        sp = np.where(~fits)[0]
        if sp.size:
            srids, sps = rids[sp], ps[sp]
            layers = srids // (self.bs * self.max_pages)
            spill_dst = self._spill_target(dst)
            if spill_dst == src:
                # Spilling back into the source pool: the rows never left it.
                self._tables.insert(_POOL[src], srids, sps)
                self._commit_tables()
                self._set_placement(srids, src)
                actual[sp] = src
            else:
                sub = dict(zip(PAYLOAD_KEYS, self._gather_rows(_POOL[src], layers, sps)))
                for x in sps:
                    self._free_slot(_POOL[src], int(x))
                self._pool_slot[srids] = -3
                sub = self.transcode_cohort(sub, src, spill_dst)
                self._spill_depth += 1
                try:
                    actual[sp] = self.commit_cohort(srids, sub, src, spill_dst)
                finally:
                    self._spill_depth -= 1
        return actual

    def _spill_target(self, dst: int) -> int:
        """Down-tier destination for pages that no longer fit at commit: WARM
        -> COLD -> HOST4; when the host device is down, a top-level COLD
        overflow is redirected into WARM if WARM has room."""
        spill = COLD if dst == WARM else HOST4
        if (
            spill == HOST4
            and self._spill_depth == 0
            and self._dev_names[HOST4] in self._down_devices
            and self._alloc["warm"].used < self._alloc["warm"].capacity
        ):
            return WARM
        return spill

    def device_of(self, level: int) -> str:
        """Backing-media device name for a placement level."""
        return self._dev_names[int(level)]

    def page_stored_bytes(self, level: int) -> int:
        """Media bytes one page occupies at a placement level."""
        return int(self._page_stored_bytes[int(level)])

    def on_pipeline_drained(self) -> None:
        """After a batch fully commits: reconcile the desired placement with
        physical reality and feed the executed media busy time (speculative
        traffic excluded) back to the manager as contention pressure."""
        for rids in self._pending_reconcile:
            ex = rids[self._page_exists[rids] & (self.physical[rids] != INFLIGHT)]
            self.manager.placement[ex] = self.physical[ex]
        self._pending_reconcile.clear()
        spec = self.pipeline.prefetch_busy_by_device
        busy = {n: q.busy_s - spec.get(n, 0.0) for n, q in self.media_queues.items()}
        delta = {n: busy[n] - self._media_busy_snapshot.get(n, 0.0) for n in busy}
        self._media_busy_snapshot = busy
        window_s = self.manager.cfg.window_steps * self.pipeline.step_period_s
        self.manager.note_media_charges(delta, window_s)

    def drain_migrations(self) -> int:
        """Block until every in-flight migration cohort commits."""
        if self.pipeline.busy:
            return self.pipeline.drain()
        return 0

    # ------------------------------------------------ speculative prefetch
    @traced("cache.prefetch_tick")
    def prefetch_tick(self) -> bool:
        """One decode step's speculative work: emit this window's warming
        cohort (at most one non-empty emission per window) and advance
        speculative staging one phase. A no-op while demand cohorts fly."""
        if not self.prefetch_enabled or self.pipeline.busy:
            return False
        if not self._prefetch_window_emitted:
            if self._emit_prefetch():
                self._prefetch_window_emitted = True
        return self.pipeline.tick()

    def _emit_prefetch(self) -> int:
        """Ask the predictor for warming host pages and queue their raw
        source-codec bytes for speculative staging."""
        eligible = ((self.physical == HOST8) | (self.physical == HOST4)) & self._page_exists
        for rid in self.pipeline.speculative_rids():
            eligible[rid] = False
        if not eligible.any():
            return 0
        fast = int(((self.physical == WARM) | (self.physical == COLD)).sum())
        cand = self.manager.prefetch_candidates(
            eligible, top_k=max(fast, 1), max_regions=self.prefetch_max_pages
        )
        if cand.size == 0:
            return 0
        cohorts = [
            (cand[self.physical[cand] == s], int(s))
            for s in (HOST8, HOST4)
            if bool((self.physical[cand] == s).any())
        ]
        return self.pipeline.submit_prefetch(cohorts)

    # ------------------------------------------------- per-page migration
    # The per-page path: the equivalence oracle of ``migrate_batch`` and the
    # single-page evictions of ``append_page``. Pages round-trip through
    # their dequantized f32 form, one page per launch.
    def migrate(self, rid: int, dst: int) -> None:
        """Move one page to placement ``dst`` (dequantize, requantize)."""
        src = int(self.physical[rid])
        if src == dst or src == INFLIGHT or not self._page_exists[rid]:
            return
        layer, slot, page = self.rid_coords(rid)
        k, v = self._fetch_dense(rid, layer, slot, page)
        self._remove(rid, layer, slot, page)
        self._insert(rid, layer, slot, page, k, v, dst)

    def rid_coords(self, rid: int) -> Tuple[int, int, int]:
        layer = rid // (self.bs * self.max_pages)
        slot = (rid // self.max_pages) % self.bs
        page = rid % self.max_pages
        return layer, slot, page

    def _quant_page(self, kpage, vpage, bits: int):
        self.kernel_dispatches += 2
        kp, ks = kops.quant_pages(kpage[None], bits)
        vp, vs = kops.quant_pages(vpage[None], bits)
        return kp[0], ks[0], vp[0], vs[0]

    def _decode_pages(self, pay: torch.Tensor, sc: torch.Tensor, level: int) -> torch.Tensor:
        """Pages stored at placement ``level`` back to f32 on the cache's
        device, in one launch: a HOST8 page on the ``cxl_hw`` expander reads
        through ``cxl_decode_pages`` (the controller decompresses inline),
        every other level through ``dequant_pages``. Both give int8 (or
        int4) times the scale, the same values."""
        if level == HOST8 and self._dev_names[HOST8] == "cxl_hw":
            return kops.cxl_decode_pages(pay, sc)
        return kops.dequant_pages(pay, sc, self._bits[level], torch.float32)

    def _fetch_dense(self, rid, layer, slot, page):
        """Decompress a page from wherever it lives: two decode launches
        (K, V) on the cache's device, f32 out (``_decode_pages``)."""
        src = int(self.physical[rid])
        ps = int(self._pool_slot[rid])
        self.kernel_dispatches += 2
        if src in _DEVICE:
            k_pay, k_sc, v_pay, v_sc = self._gather_rows(_POOL[src], layer, ps)
        else:
            k_pay, k_sc, v_pay, v_sc = (
                torch.as_tensor(x, device=self.device) for x in self.host_pages[rid]
            )
        return (self._decode_pages(k_pay[None], k_sc[None], src)[0],
                self._decode_pages(v_pay[None], v_sc[None], src)[0])

    def _remove(self, rid, layer, slot, page):
        src = int(self.physical[rid])
        ps = int(self._pool_slot[rid])
        if src in _DEVICE:
            self._tables.remove(_POOL[src], [rid], [ps])
            self._commit_tables()
            self._free_slot(_POOL[src], ps)
        else:
            self._invalidate_prefetch(np.array([rid], np.int64))
            self._host_sentinel_remove(np.array([rid], np.int64), np.array([layer]))
            self.host_pages.pop(rid, None)
        self._pool_slot[rid] = -1

    def _insert(self, rid, layer, slot, page, k, v, dst):
        tenant = self._tenant_of_rid(rid)
        if dst == WARM and self._pool_headroom("warm", tenant) == 0:
            scoped = tenant if self._quota_headroom("warm", tenant) == 0 else None
            if not self._evict_coldest_warm(tenant=scoped):
                dst = COLD  # nothing demotable; spill to the next tier
            elif self._pool_headroom("warm", tenant) == 0:
                dst = COLD  # eviction freed no usable headroom
        if dst == COLD and self._pool_headroom("cold", tenant) == 0:
            dst = HOST4  # cold quota exhausted; spill to the host tier
        bits = self._bits[dst]
        kp, ks, vp, vs = self._quant_page(k, v, bits)
        if dst in _DEVICE:
            pool = _POOL[dst]
            ps = self._alloc_slot(pool, rid)
            self._scatter_rows(pool, layer, ps, kp, ks, vp, vs)
            self._pool_slot[rid] = ps
            self._tables.insert(pool, [rid], [ps])
            self._commit_tables()
        else:
            self.host_pages[rid] = tuple(_np(x) for x in (kp, ks, vp, vs))
            self._pool_slot[rid] = -2
        self._set_placement(rid, dst)
        if dst not in _DEVICE:
            self._host_sentinel_insert(
                np.array([rid], np.int64), np.array([layer]), _np(kp)[None], _np(ks)[None], dst
            )

    # ------------------------------------------------------------ release
    def release_slot_pages(self, slot: int) -> None:
        """Request finished: free all of one batch slot's pages, batched. If
        any of this slot's pages ride a queued cohort the pipeline drains
        first: in flight, they must not strand in the staging ring; still
        pending, the cohort would later stage freed pages, or the pages of
        the slot's next request under the same region ids. (The reference
        drains only for pages in flight, and a pending cohort of a freed
        slot fails when it stages; ROADMAP §3.)"""
        rids = np.array(
            [self.rid(layer, slot, page)
             for layer in range(self.la) for page in range(self.max_pages)],
            np.int64,
        )
        if self.pipeline.busy and self.pipeline.holds_any(rids):
            self.pipeline.drain()
        rids = rids[self._page_exists[rids]]
        self._invalidate_prefetch(rids)
        for r in rids:
            src = int(self.physical[r])
            ps = int(self._pool_slot[r])
            if src == WARM:
                self._free_slot("warm", ps)
            elif src == COLD:
                self._free_slot("cold", ps)
            else:
                if self._host_slot[r] >= 0:
                    layer = int(r) // (self.bs * self.max_pages)
                    self._host_alloc[layer].free(int(self._host_slot[r]))
                self.host_pages.pop(int(r), None)
        self._pool_slot[rids] = -1
        self._host_slot[rids] = -1
        self._page_exists[rids] = False
        self.physical[rids] = 0
        self.manager.placement[rids] = 0
        self._tables.clear_slot(self.state, slot)

    # ------------------------------------------- preemption-to-host-tier
    # The serving frontend parks a victim slot's KV on the host tier when a
    # higher-SLA request needs its batch slot, and swaps it back in on
    # resume — zero re-prefill. Three phases: demote (device pages -> same
    # codec host tier through the media pipeline, billed like any other
    # demotion), park (lift payloads + recent window out of the region
    # space), restore (re-register under a free slot, swap device-bound
    # pages back in through the pipeline).
    def slot_rids(self, slot: int) -> np.ndarray:
        """All live region ids currently owned by ``slot``."""
        return np.where(self._page_exists & (self._rid_slot == slot))[0]

    def demote_slot_to_host(self, slot: int) -> Dict[int, int]:
        """Preemption phase 1: demote every device-resident page of ``slot``
        to the host tier of its OWN codec class (int8 -> HOST8, int4 ->
        HOST4: a raw media copy with no transcode launch, so the stored
        payload survives bit-exactly). Runs through the media pipeline, so
        media-queue bytes and kernel dispatches are billed exactly like a
        window boundary's demotion cohorts. Returns rid -> pre-demotion
        placement (``restore_slot``'s swap-in plan)."""
        if self.pipeline.busy:
            self.pipeline.drain()
        rids = self.slot_rids(slot)
        orig = {int(r): int(self.physical[r]) for r in rids}
        on_dev = rids[np.isin(self.physical[rids], _DEVICE)]
        if on_dev.size:
            bits = np.array([self._bits[int(s)] for s in self.physical[on_dev]])
            dsts = np.where(bits == 8, HOST8, HOST4).astype(np.int64)
            self.pipeline.submit(self.plan_cohorts(on_dev, dsts))
            self.pipeline.drain()
        return orig

    def park_slot(
        self, slot: int, restore_levels: Optional[Dict[int, int]] = None
    ) -> ParkedSlot:
        """Preemption phase 2: detach the slot's (now host-resident) pages
        and its recent-window rows from the cache. Host payload slots,
        sentinel rows and region ids all free, so the batch slot is at once
        reusable. ``restore_levels`` (from ``demote_slot_to_host``) records
        where each page lives again after resume; pages it omits stay on
        their parked host tier. Staged prefetch copies of the slot's pages
        are invalidated (counted in ``prefetch_invalidated``)."""
        if self.pipeline.busy:
            self.pipeline.drain()
        rids = self.slot_rids(slot)
        if bool(np.isin(self.physical[rids], _DEVICE).any()):
            raise ValueError(
                f"park_slot({slot}): device-resident pages remain — call "
                "demote_slot_to_host first"
            )
        restore_levels = restore_levels or {}
        self._invalidate_prefetch(rids)
        self._host_sentinel_remove(rids, rids // (self.bs * self.max_pages))
        pages = []
        for r in rids:
            r = int(r)
            layer, _, page = self.rid_coords(r)
            lvl = int(self.physical[r])
            pages.append(ParkedPage(
                layer=layer, page=page, host_level=lvl,
                restore_level=int(restore_levels.get(r, lvl)),
                payload=self.host_pages.pop(r),
            ))
        self._page_exists[rids] = False
        self.physical[rids] = 0
        self.manager.placement[rids] = 0
        self._pool_slot[rids] = -1
        self._host_slot[rids] = -1
        st = self.state
        parked = ParkedSlot(
            tenant=int(self.slot_tenant[slot]),
            pages=pages,
            recent_k=st.recent_k[:, slot].to("cpu", copy=True),
            recent_v=st.recent_v[:, slot].to("cpu", copy=True),
            recent_len=int(st.recent_len[slot]),
            total_len=int(st.total_len[slot]),
        )
        self._tables.clear_slot(st, slot, ("host",))
        st.recent_len[slot] = 0
        st.total_len[slot] = 0
        return parked

    def restore_slot(self, slot: int, parked: ParkedSlot) -> int:
        """Resume phase: re-register a parked request's pages under ``slot``
        (which must hold none) and swap the previously device-resident ones
        back in through the media pipeline — same-codec raw copies again, so
        every payload lands bit-exactly where its codec class stores it.
        The recent window and positions restore verbatim; the next decode
        step continues as if the preemption never happened. Returns the
        number of pages restored."""
        if self.slot_rids(slot).size:
            raise ValueError(f"restore_slot({slot}): target slot still holds pages")
        if self.pipeline.busy:
            self.pipeline.drain()
        self.set_slot_tenant(slot, parked.tenant)
        # Re-insert host payloads in layer-major logical page order so table
        # rows append in the order an uninterrupted run built them (the
        # split attention kernel merges a sequence's rows in table order).
        pages = sorted(parked.pages, key=lambda pg: (pg.layer, pg.page))
        rids = np.array([self.rid(pg.layer, slot, pg.page) for pg in pages], np.int64)
        if rids.size:
            if bool(self._page_exists[rids].any()):
                raise ValueError(f"restore_slot({slot}): region ids already live")
            levels = np.array([pg.host_level for pg in pages], np.int64)
            for r, pg in zip(rids, pages):
                self.host_pages[int(r)] = pg.payload
            self._page_exists[rids] = True
            self._pool_slot[rids] = -2
            self._set_placement(rids, levels)
            layers = rids // (self.bs * self.max_pages)
            for lvl in (HOST8, HOST4):
                sel = np.where(levels == lvl)[0]
                if sel.size:
                    kp = np.stack([pages[i].payload[0] for i in sel])
                    ks = np.stack([pages[i].payload[1] for i in sel])
                    self._host_sentinel_insert(rids[sel], layers[sel], kp, ks, lvl)
        # Recent window + positions land exactly as parked.
        st = self.state
        st.recent_k[:, slot] = parked.recent_k.to(self.device, st.recent_k.dtype)
        st.recent_v[:, slot] = parked.recent_v.to(self.device, st.recent_v.dtype)
        st.recent_len[slot] = parked.recent_len
        st.total_len[slot] = parked.total_len
        swap = np.array(
            [i for i, pg in enumerate(pages) if pg.restore_level in _DEVICE], np.int64
        )
        if swap.size:
            dsts = np.array([pages[i].restore_level for i in swap], np.int64)
            self.pipeline.submit(self.plan_cohorts(rids[swap], dsts))
            self.pipeline.drain()
        return int(rids.size)

    # ------------------------------------------------------------ telemetry
    @traced("cache.fold_telemetry")
    def record_telemetry(self, telemetry: Dict[str, np.ndarray]) -> None:
        """Fold per-step page masses ([L, B, MP] normalized, per pool) into
        region hotness counts through the host tables' rids: no table is
        read off the device. The "host" key (sentinel would-have-touched
        mass) is tracked as the quality cost of the host tiers and fed to
        ``manager.record_host_mass`` — never into the placement-driving
        access counts."""
        table_of = self._table_of_region()
        counts = self._fold_telemetry(telemetry, table_of)
        counts *= 1000.0
        self.manager.record_access_counts(counts)
        host_mass = telemetry.get("host")
        if host_mass is not None:
            counts = self._fold_host_mass(host_mass, table_of)
            counts *= 1000.0
            self.manager.record_host_mass(counts)
        self.attn_launches += self.la * kops.decode_launches_per_step(n_pools=len(_POOL))

    def _table_of_region(self) -> np.ndarray:
        """(n_regions + 1,) int8: the table code (``_TABLE_CODE``) of each
        region's page, 0 where none exists or it is in flight. The extra last
        element, 0, is what an empty entry's rid (-1) reads."""
        out = np.zeros(self.n_regions + 1, np.int8)
        np.multiply(_TABLE_OF_LEVEL[self.physical], self._page_exists, out=out[:-1])
        return out

    def _fold(self, masses: Dict[str, np.ndarray], table_of=None) -> np.ndarray:
        """Sum per-entry masses [L, B, M] of the named tables onto region
        ids: an entry counts when it holds a rid (it lies below its row's
        count) whose page exists at that table's level (in-flight pages drop
        out). A region holds at most one entry in one table, so each count
        is its one mass in float64, as the reference's ``np.add.at`` over
        its (layer, pool row) -> rid map gives it."""
        t = self._tables
        if table_of is None:
            table_of = self._table_of_region()
        rids, weights = [], []
        for pool, mass in masses.items():
            mass = _np(mass)
            # Rows fill from the front: no entry lies past the longest row.
            m = min(mass.shape[2], int(t.counts[pool].max()))
            r = t.rids[pool][:, :, :m].ravel()
            keep = table_of[r] == _TABLE_CODE[pool]
            rids.append(r[keep])
            weights.append(mass[:, :, :m].ravel()[keep])
        counts = np.bincount(np.concatenate(rids), np.concatenate(weights),
                             minlength=self.n_regions)
        return counts.astype(np.float64, copy=False)  # an empty fold counts in int64

    def _fold_telemetry(self, telemetry, table_of=None) -> np.ndarray:
        return self._fold({pool: telemetry[pool] for pool in _POOL.values()}, table_of)

    def _fold_host_mass(self, mass, table_of=None) -> np.ndarray:
        """Fold sentinel would-have-touched masses [L, B, MPh] into region
        counts, against the host sentinel table."""
        return self._fold({"host": mass}, table_of)

    def _observe_adaptive_media(self) -> None:
        """Feed compressibility-adaptive media devices the real encoded
        sizes of resident host payloads (an inline line compressor narrows
        any 64-codeword line whose bytes fit int4 range; scales ride
        uncompressed). Runs at the window boundary after the pipeline
        drained, where serial and async runs hold byte-identical
        ``host_pages``."""
        adaptive = adaptive_devices(self.media_queues)
        if not adaptive:
            return
        line = codecs.CXL_LINE_ELEMS
        for name, dev in adaptive.items():
            levels = [lvl for lvl in (HOST8, HOST4) if self._dev_names[lvl] == name]
            if not levels:
                dev.commit_window()
                continue
            nominal = 0
            wire = 0
            for lvl in levels:
                rids = np.nonzero((self.physical == lvl) & self._page_exists)[0]
                for rid in rids:
                    kp, ks, vp, vs = self.host_pages[int(rid)]
                    for pay in (kp, vp):
                        nominal += int(pay.size) * int(pay.dtype.itemsize)
                        q = np.ascontiguousarray(pay).reshape(-1).view(np.int8)
                        n_lines = q.size // line
                        if n_lines:
                            bits = codecs.cxl_line_bits(torch.from_numpy(q[: n_lines * line]))
                            wire += int(bits.sum()) * line // 8
                        wire += q.size - n_lines * line
                    for sc in (ks, vs):
                        b = int(sc.size) * int(sc.dtype.itemsize)
                        nominal += b
                        wire += b
            if nominal > 0:
                dev.observe(float(nominal), float(wire))
                ratio = float(nominal) / float(max(wire, 1))
                self.manager.note_media_ratio(name, ratio)
                nominal_ratios = self.manager.tierset.ratios()
                for lvl in levels:
                    self.manager.update_measured_ratio(lvl, nominal_ratios[lvl] * ratio)
            dev.commit_window()

    def _advance_fault_window(self) -> None:
        """Advance the fault clock one window and fold fault telemetry into
        the manager (down devices, retries, corruptions, aborts). Runs after
        the pipeline drained and before the manager plans, the same point in
        serial and async runs."""
        self._fault_window += 1
        for q in self.media_queues.values():
            q.device.note_window(self._fault_window)
        self._down_devices = {
            q.device.name for q in self.media_queues.values() if q.device.down_now()
        }
        self.manager.note_devices_down(self._down_devices)
        p = self.pipeline
        cur = (p.fault_retries, p.corruptions_detected, p.cohorts_aborted)
        prev = self._fault_counter_snapshot
        self.manager.note_fault_events(
            retries=cur[0] - prev[0],
            corruptions=cur[1] - prev[1],
            aborted=cur[2] - prev[2],
        )
        self._fault_counter_snapshot = cur

    # --------------------------------------------------------- window logic
    def end_window(self):
        """Run the placement model over existing pages and execute the plan.

        Serial mode (the oracle): the batched cohort executor runs the plan
        to completion before returning. Async mode: the cohorts go to the
        media pipeline and the boundary returns; decode steps tick the
        pipeline and the desired/physical reconcile happens when the batch
        drains. A previous window's stragglers drain first, speculative
        cohorts finish into the held store, and moves touching a down device
        are deferred before the mode split. Three spans: ``cache.drain``,
        ``cache.policy`` and ``cache.submit``."""
        tr = self.tracer
        with tr.span("cache.drain"):
            if self.pipeline.busy:
                self.pipeline.drain()
            if self.prefetch_enabled:
                self.pipeline.finish_speculative()
        with tr.span("cache.policy"):
            self._observe_adaptive_media()
            if self.fault_plan is not None:
                self._advance_fault_window()
            plan = self.manager.end_window()
            self._prefetch_window_emitted = False
        return self._submit_plan(plan)

    @traced("cache.submit")
    def _submit_plan(self, plan):
        """The boundary's plan onto the executor: cohorts, the claim or
        discard of prefetched pages and the submission (async), or the
        batched migration (serial)."""
        if plan.regions.size == 0:
            if self.prefetch_enabled:
                self.pipeline.discard_speculative()  # nothing to claim: all misses
            return plan, 0
        # The manager may recommend DRAM(0) for hot pages; KV pages go warm
        # instead (the recent window plays DRAM's role).
        regions = np.asarray(plan.regions, np.int64)
        dst = plan.dst.copy()
        dst[dst == 0] = WARM
        if self._down_devices:
            down_idx = np.array(
                [i for i, n in enumerate(self._dev_names) if n in self._down_devices],
                np.int64,
            )
            bad = np.isin(self.physical[regions], down_idx) | np.isin(dst, down_idx)
            self.fault_deferred_pages += int(bad.sum())
            regions, dst = regions[~bad], dst[~bad]
        if self.async_migration:
            cohorts = self.plan_cohorts(regions, dst)
            prestaged: Dict[int, Dict[str, torch.Tensor]] = {}
            if self.prefetch_enabled:
                # Claim held pages the plan confirmed (hits); discard the
                # rest (misses), returning their ring credits.
                for crids, s, _d in cohorts:
                    if s not in _DEVICE:
                        prestaged.update(self.pipeline.claim_prefetched(crids, s))
                self.pipeline.discard_speculative()
            self._pending_reconcile.append(np.asarray(plan.regions, np.int64))
            queued = self.pipeline.submit(cohorts, prestaged=prestaged or None)
            if not self.pipeline.busy:
                self.on_pipeline_drained()  # empty after the pre-passes
            return plan, queued
        moved = self.migrate_batch(regions, dst)
        # Price reality: actual placements (spills included), planned no-ops
        # and fault-deferred moves go back into manager.placement.
        ex = plan.regions[self._page_exists[plan.regions]]
        self.manager.placement[ex] = self.physical[ex]
        return plan, moved

    # ------------------------------------------------------------- metrics
    def tco_usd(self, tenant: Optional[int] = None) -> float:
        """Memory TCO of *existing* pages under the current placement,
        optionally restricted to one tenant's pages."""
        exists = self._page_exists
        if tenant is not None:
            exists = exists & self.tenant_mask(tenant)
        if not exists.any():
            return 0.0
        costs = tco.usd_per_region(
            self.manager.tierset, self.manager.region_bytes, self.manager.measured_ratios
        )
        return float(costs[self.manager.placement[exists]].sum())

    def tco_savings_pct(self, tenant: Optional[int] = None) -> float:
        """Savings vs holding every existing page uncompressed in HBM."""
        exists = self._page_exists
        if tenant is not None:
            exists = exists & self.tenant_mask(tenant)
        n = int(exists.sum())
        if n == 0:
            return 0.0
        mx = tco.tco_max(n, self.manager.region_bytes)
        return 100.0 * (mx - self.tco_usd(tenant)) / mx
