"""Tiered paged KV cache: device pools + host tiers + page tables, after
``repro.serving.kv_cache`` (the serial, blocking migration executor).

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
numpy too. Device state is ``TieredKVState`` tensors: page tables are edited
on the host and committed to the device once per batch, and the class
buffers are written in place (the reference's functional ``.at[].set``).
``manager.placement`` is the policy's desired placement, ``self.physical``
where each page's payload actually lives; ``migrate_batch`` reconciles them
cohort by cohort with one ``transcode_pages`` launch per transcoding cohort.
The per-page ``migrate`` path is its equivalence oracle and serves the
single-page evictions of ``append_page``.

Not ported yet (later slices): the async media pipeline, speculative
prefetch, fault injection, adaptive media and preemption (park/restore).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tco
from repro_torch.core.manager import ManagerConfig, TierScapeManager
from repro_torch.core.pools import ClassPartition, SlotAllocator, exchange_slots
from repro_torch.core.tiers import TierSet, get as get_tier
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.runtime.serve import CLASS_FIELDS, TieredKVState, init_tiered_kv_state

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
# A page in flight between tiers (the async pipeline's marker; the serial
# executor never leaves one, but every placement mask excludes it).
INFLIGHT = -1


def _np(x) -> np.ndarray:
    """Host numpy view of a tensor (copied off the device) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def kv_tierset(page_elems: int, warm_bits: int = 8, cold_bits: int = 4) -> TierSet:
    """TierSet for a device-pool codec split: (C5, C9, C7, C10) by default
    (int8-HBM, int4-HBM, int8-host, int4-host); same-width splits pick the
    matching characterized tiers so byte/latency accounting follows the
    deployed codecs."""
    ids = (
        _DEVICE_TIER_IDS[("warm", int(warm_bits))],
        _DEVICE_TIER_IDS[("cold", int(cold_bits))],
        "C7",
        "C10",
    )
    return TierSet(tiers=tuple(get_tier(t) for t in ids), block_elems=page_elems)


class _TableEditor:
    """Batched host-side edits of the device page tables: all mutations of
    one migrate/append batch happen on numpy copies and ``commit`` writes
    each table back to the device once. Covers the host sentinel table too."""

    _POOLS = ("warm", "cold", "host")

    def __init__(self, state: TieredKVState):
        self.tables = {p: _np(getattr(state, f"{p}_table")).copy() for p in self._POOLS}
        self.counts = {p: _np(getattr(state, f"{p}_n")).copy() for p in self._POOLS}

    def remove(self, pool: str, layers, slots, pool_slots) -> None:
        t, c = self.tables[pool], self.counts[pool]
        for la, sl, ps in zip(layers, slots, pool_slots):
            n = int(c[la, sl])
            row = t[la, sl]
            idx = int(np.where(row[:n] == ps)[0][0])
            row[idx] = row[n - 1]
            row[n - 1] = 0
            c[la, sl] = n - 1

    def insert(self, pool: str, layers, slots, pool_slots) -> None:
        t, c = self.tables[pool], self.counts[pool]
        for la, sl, ps in zip(layers, slots, pool_slots):
            n = int(c[la, sl])
            t[la, sl, n] = ps
            c[la, sl] = n + 1

    def commit(self, state: TieredKVState) -> TieredKVState:
        dev = state.warm_table.device
        kw = {}
        for p in self._POOLS:
            kw[f"{p}_table"] = torch.as_tensor(self.tables[p], device=dev)
            kw[f"{p}_n"] = torch.as_tensor(self.counts[p], device=dev)
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
        pool_bits: Optional[Dict[str, int]] = None,
        device="cuda",
    ):
        """``tenant_quota`` maps pool name ("warm"/"cold") -> {tenant id ->
        max concurrently held slots}; quota exhaustion spills that tenant's
        pages down-tier. ``pool_bits`` maps pool name -> codec width (8 or 4)
        for the device pools, default ``{"warm": 8, "cold": 4}``; pools of
        the same width share one codec-class buffer."""
        self.device = resolve_device(device)
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
        # Host tier pools: region id -> (k_pay, k_sc, v_pay, v_sc) numpy.
        self.host_pages: Dict[int, Tuple[np.ndarray, ...]] = {}

        # Region space: (layer, slot, page) flattened.
        self.n_regions = total_pages
        self.manager = TierScapeManager(
            kv_tierset(self.page_elems, wb, cb),
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
        self.quality_skipped_mass = 0.0  # cumulative mass of host-excluded pages
        # Compute-kernel dispatches of the ingestion/migration path
        # (quant / dequant / transcode — the daemon-tax proxy).
        self.kernel_dispatches = 0
        # Decode-side attention launches billed per step by
        # ``kops.decode_launches_per_step`` (1 per layer on the fused path).
        self.attn_launches = 0
        self.decode_steps_recorded = 0

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

    # ------------------------------------------------- host sentinel rows
    # Every page on a host tier carries a sentinel: its key centroid (mean
    # over the page's T tokens of the dequantized stored K payload) in
    # ``state.host_summary`` plus a ``host_table`` entry.
    def _host_sentinel_insert(
        self, rids, layers, slots, k_pay, k_sc, bits: int,
        editor: Optional[_TableEditor] = None,
    ) -> None:
        rids = np.asarray(rids, np.int64)
        if rids.size == 0:
            return
        self.kernel_dispatches += 1
        deq = kref.dequant_kv_page(torch.as_tensor(_np(k_pay)), torch.as_tensor(_np(k_sc)), bits)
        summ = deq.numpy().mean(axis=1)  # [P, KV, hd], numpy's f32 mean as the reference
        hs = np.array(
            [self._host_alloc[int(la)].alloc(int(r)) for la, r in zip(layers, rids)],
            np.int64,
        )
        self.state.host_summary[self._ix(layers), self._ix(hs)] = torch.as_tensor(
            summ, device=self.device
        )
        own = editor is None
        editor = editor or _TableEditor(self.state)
        editor.insert("host", layers, slots, hs)
        if own:
            self.state = editor.commit(self.state)
        self._host_slot[rids] = hs

    def _host_sentinel_remove(
        self, rids, layers, slots, editor: Optional[_TableEditor] = None
    ) -> None:
        rids = np.asarray(rids, np.int64)
        if rids.size == 0:
            return
        hs = self._host_slot[rids]
        own = editor is None
        editor = editor or _TableEditor(self.state)
        editor.remove("host", layers, slots, hs)
        if own:
            self.state = editor.commit(self.state)
        for la, x in zip(layers, hs):
            self._host_alloc[int(la)].free(int(x))
        self._host_slot[rids] = -1

    # -------------------------------------------------- page ingestion path
    def append_pages(self, entries: Sequence[Tuple[int, int, int]], kpages, vpages) -> None:
        """Batched ingestion: quantize all N new pages with one kernel
        launch per destination tier (K and V stacked into one batch) and
        commit the page tables once. ``entries`` is [(layer, slot, page)];
        kpages/vpages are [N, T, KV, hd] float tensors."""
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

        editor = _TableEditor(self.state)
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
                    dst, rids[sel], layers[sel], slots[sel],
                    pay[:p], sc[:p], pay[p:], sc[p:], editor,
                )
            else:
                kp, ks = _np(pay[:p]), _np(sc[:p])
                vp, vs = _np(pay[p:]), _np(sc[p:])
                for j, r in enumerate(rids[sel]):
                    self.host_pages[int(r)] = (kp[j], ks[j], vp[j], vs[j])
                self._pool_slot[rids[sel]] = -2
                self._set_placement(rids[sel], dst)
                self._host_sentinel_insert(
                    rids[sel], layers[sel], slots[sel], kp, ks, bits, editor
                )
            if dst == WARM:
                kp_sz = int(pay[:p].numel())
                sc_sz = int(sc[:p].numel())
                for _ in range(p):
                    self.manager.update_measured_ratio(
                        WARM, 2.0 * (kp_sz / p) / (kp_sz / p + 4 * sc_sz / p)
                    )
        self.state = editor.commit(self.state)
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
        self._table_append("warm", layer, slot, ps)
        self._set_placement(rid, WARM)
        self._page_exists[rid] = True
        self._pool_slot[rid] = ps
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
        editor = _TableEditor(self.state)
        moved = 0
        for crids, s, d in cohorts:
            self._exec_cohort(crids, s, d, editor)
            moved += int(crids.size)
        self.state = editor.commit(self.state)
        return moved

    def _exec_cohort(self, rids: np.ndarray, src: int, dst: int, editor: _TableEditor) -> None:
        """Move one (src, dst) cohort: gather -> (transcode | copy) ->
        scatter. Same-class device moves only transfer row ownership and
        re-point the page tables — zero payload bytes move."""
        p = rids.size
        layers = rids // (self.bs * self.max_pages)
        slots = (rids // self.max_pages) % self.bs

        if self._same_class(src, dst):
            ps = self._pool_slot[rids]
            editor.remove(_POOL[src], layers, slots, ps)
            self._exchange_rows(src, dst, rids, ps)
            editor.insert(_POOL[dst], layers, slots, ps)
            self._set_placement(rids, dst)
            return

        # Gather the cohort (K pages then V pages, so one kernel launch
        # covers both).
        if src in _DEVICE:
            pool = _POOL[src]
            ps = self._pool_slot[rids]
            k_pay, k_sc, v_pay, v_sc = self._gather_rows(pool, layers, ps)
            editor.remove(pool, layers, slots, ps)
            for x in ps:
                self._free_slot(pool, int(x))
        else:
            self._host_sentinel_remove(rids, layers, slots, editor)
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
            self._scatter_device(dst, rids, layers, slots, k_pay, k_sc, v_pay, v_sc, editor)
        else:
            kp, ks = _np(k_pay), _np(k_sc)
            vp, vs = _np(v_pay), _np(v_sc)
            for i, r in enumerate(rids):
                self.host_pages[int(r)] = (kp[i], ks[i], vp[i], vs[i])
            self._pool_slot[rids] = -2
            self._set_placement(rids, dst)
            self._host_sentinel_insert(rids, layers, slots, kp, ks, self._bits[dst], editor)

    def _scatter_device(self, dst, rids, layers, slots, k_pay, k_sc, v_pay, v_sc, editor):
        pool = _POOL[dst]
        new_ps = np.array([self._alloc_slot(pool, int(r)) for r in rids], np.int64)
        self._scatter_rows(pool, layers, new_ps, k_pay, k_sc, v_pay, v_sc)
        editor.insert(pool, layers, slots, new_ps)
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

    def _fetch_dense(self, rid, layer, slot, page):
        """Decompress a page from wherever it lives (f32 on the device)."""
        src = int(self.physical[rid])
        ps = int(self._pool_slot[rid])
        self.kernel_dispatches += 2
        if src in _DEVICE:
            k_pay, k_sc, v_pay, v_sc = self._gather_rows(_POOL[src], layer, ps)
        else:
            k_pay, k_sc, v_pay, v_sc = (
                torch.as_tensor(x, device=self.device) for x in self.host_pages[rid]
            )
        bits = self._bits[src]
        return (kref.dequant_kv_page(k_pay, k_sc, bits),
                kref.dequant_kv_page(v_pay, v_sc, bits))

    def _remove(self, rid, layer, slot, page):
        src = int(self.physical[rid])
        ps = int(self._pool_slot[rid])
        if src in _DEVICE:
            self._table_remove(_POOL[src], layer, slot, ps)
            self._free_slot(_POOL[src], ps)
        else:
            self._host_sentinel_remove(
                np.array([rid], np.int64), np.array([layer]), np.array([slot])
            )
            self.host_pages.pop(rid, None)
        self._pool_slot[rid] = -1

    def _table_remove(self, pool: str, layer: int, slot: int, pool_slot: int):
        """Drop one entry from a device page-table row (swap with the last)."""
        editor = _TableEditor(self.state)
        editor.remove(pool, [layer], [slot], [pool_slot])
        self.state = editor.commit(self.state)

    def _table_append(self, pool: str, layer: int, slot: int, pool_slot: int):
        editor = _TableEditor(self.state)
        editor.insert(pool, [layer], [slot], [pool_slot])
        self.state = editor.commit(self.state)

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
            self._table_append(pool, layer, slot, ps)
        else:
            self.host_pages[rid] = tuple(_np(x) for x in (kp, ks, vp, vs))
            ps = -2
        self._set_placement(rid, dst)
        self._pool_slot[rid] = ps
        if dst not in _DEVICE:
            self._host_sentinel_insert(
                np.array([rid], np.int64), np.array([layer]), np.array([slot]),
                _np(kp)[None], _np(ks)[None], bits,
            )

    # ------------------------------------------------------------ release
    def release_slot_pages(self, slot: int) -> None:
        """Request finished: free all of one batch slot's pages, batched."""
        rids = np.array(
            [self.rid(layer, slot, page)
             for layer in range(self.la) for page in range(self.max_pages)],
            np.int64,
        )
        rids = rids[self._page_exists[rids]]
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
        st = self.state
        for f in ("warm_n", "cold_n", "host_n"):
            getattr(st, f)[:, slot] = 0

    # ------------------------------------------------------------ telemetry
    def record_telemetry(self, telemetry: Dict[str, np.ndarray]) -> None:
        """Fold per-step page masses ([L, B, MP] normalized, per pool) into
        region hotness counts through the tables' (layer, pool_slot) -> rid
        lookup. The "host" key (sentinel would-have-touched mass) is tracked
        as the quality cost of the host tiers and fed to
        ``manager.record_host_mass`` — never into the placement-driving
        access counts."""
        self.manager.record_access_counts(self._fold_telemetry(telemetry) * 1000.0)
        host_mass = telemetry.get("host")
        if host_mass is not None:
            folded = self._fold_host_mass(host_mass)
            self.quality_skipped_mass += float(folded.sum())
            self.manager.record_host_mass(folded * 1000.0)
        self.attn_launches += self.la * kops.decode_launches_per_step(n_pools=len(_POOL))
        self.decode_steps_recorded += 1

    def _fold_table_mass(self, counts, mass, table, nvec, cap, live, slot_of) -> None:
        """Accumulate per-table-entry ``mass`` [L, B, M] onto region ids.
        The validity mask is threefold: prefix count, mapped rid exists, and
        the rid belongs to this (layer, slot) row."""
        rid_of = np.full((self.la, cap), -1, np.int64)
        rid_of[live // (self.bs * self.max_pages), slot_of[live]] = live
        m = min(mass.shape[2], table.shape[2])
        entry = table[:, :, :m]  # [L,B,m]
        cand = rid_of[np.arange(self.la)[:, None, None], entry]
        valid = np.arange(m)[None, None, :] < nvec[..., None]
        valid &= cand >= 0
        valid &= ((cand // self.max_pages) % self.bs) == np.arange(self.bs)[None, :, None]
        np.add.at(counts, cand[valid], mass[:, :, :m][valid])

    def _fold_telemetry(self, telemetry) -> np.ndarray:
        counts = np.zeros(self.n_regions)
        st = self.state
        for pool, placement in (("warm", WARM), ("cold", COLD)):
            live = np.where((self.physical == placement) & self._page_exists)[0]
            if live.size == 0:
                continue
            self._fold_table_mass(
                counts,
                _np(telemetry[pool]),
                _np(getattr(st, f"{pool}_table")),
                _np(getattr(st, f"{pool}_n")),
                getattr(st, f"{self._cls[pool]}_k").shape[1],
                live,
                self._pool_slot,
            )
        return counts

    def _fold_host_mass(self, mass) -> np.ndarray:
        """Fold sentinel would-have-touched masses [L, B, MPh] into region
        counts, against the host sentinel table."""
        counts = np.zeros(self.n_regions)
        live = np.where(
            ((self.physical == HOST8) | (self.physical == HOST4)) & self._page_exists
        )[0]
        if live.size:
            st = self.state
            self._fold_table_mass(
                counts, _np(mass), _np(st.host_table), _np(st.host_n),
                st.host_summary.shape[1], live, self._host_slot,
            )
        return counts

    # --------------------------------------------------------- window logic
    def end_window(self):
        """Run the placement model over existing pages and execute the plan
        to completion before returning (the serial executor: the window
        boundary blocks)."""
        plan = self.manager.end_window()
        if plan.regions.size == 0:
            return plan, 0
        # The manager may recommend DRAM(0) for hot pages; KV pages go warm
        # instead (the recent window plays DRAM's role).
        regions = np.asarray(plan.regions, np.int64)
        dst = plan.dst.copy()
        dst[dst == 0] = WARM
        moved = self.migrate_batch(regions, dst)
        # Price reality: actual placements (spills included) and planned
        # no-ops go back into manager.placement.
        ex = plan.regions[self._page_exists[plan.regions]]
        self.manager.placement[ex] = self.physical[ex]
        return plan, moved

    # ------------------------------------------------------------- metrics
    def hbm_bytes(self) -> int:
        st = self.state
        tot = 0
        for name in ("c8_k", "c8_k_scales", "c8_v", "c8_v_scales",
                     "c4_k", "c4_k_scales", "c4_v", "c4_v_scales",
                     "recent_k", "recent_v"):
            a = getattr(st, name)
            tot += a.numel() * a.element_size()
        return tot

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
