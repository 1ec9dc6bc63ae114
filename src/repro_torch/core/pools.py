"""Compressed-pool data plane, after ``repro.core.pools``.

  * **Device side** (``TierPool``): a fixed-capacity uint8 payload + f32
    scale tensor pair for one compressed tier, one block per row, written
    and read through the tier's codec (``core.codecs``). No serving path
    uses it (the KV cache keeps its own class buffers); it is the
    reference's generic block store.
  * **Host side**: ``SlotAllocator``, ``exchange_slots``, the
    codec-class-major ``PoolRange``/``ClassPartition``, the arbiter's
    ``TenantLedger`` and ``BlockTable``. Allocation policy runs on the host
    (it is part of the daemon tax) and only integer class-row indices reach
    the device page tables.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.codecs import Encoded
from repro_torch.core.tiers import TierSpec


@dataclasses.dataclass
class TierPool:
    """Device-side storage for one compressed tier."""

    payload: torch.Tensor  # uint8 [capacity, payload_bytes]
    scales: torch.Tensor  # f32 [capacity, n_groups] (n_groups >= 1)

    @property
    def capacity(self) -> int:
        return self.payload.shape[0]


def make_tier_pool(spec: TierSpec, capacity_blocks: int, block_elems: int,
                   device="cpu") -> TierPool:
    codec = spec.codec
    pbytes = codec.payload_bytes(block_elems)
    ngroups = max(codec.scale_bytes(block_elems) // 4, 1)
    return TierPool(
        payload=torch.zeros((capacity_blocks, pbytes), dtype=torch.uint8, device=device),
        scales=torch.ones((capacity_blocks, ngroups), dtype=torch.float32, device=device),
    )


def pool_write(pool: TierPool, slot, payload_row, scales_row) -> TierPool:
    """A new pool with row ``slot`` replaced (the input pool is unchanged,
    as the reference's functional update)."""
    payload, scales = pool.payload.clone(), pool.scales.clone()
    payload[slot] = payload_row
    scales[slot] = scales_row
    return TierPool(payload=payload, scales=scales)


def pool_compress_block(spec: TierSpec, pool: TierPool, slot, block) -> TierPool:
    """Encode ``block`` with the tier's codec and store it at ``slot``."""
    enc = spec.codec.encode(block)
    scales = enc.scales
    if scales.shape[0] == 0:
        scales = torch.ones((1,), dtype=torch.float32, device=scales.device)
    return pool_write(pool, slot, enc.payload, scales)


def pool_decompress_block(spec: TierSpec, pool: TierPool, slot, shape, dtype=torch.bfloat16):
    enc = Encoded(payload=pool.payload[slot], scales=pool.scales[slot], codec=spec.codec_name)
    return spec.codec.decode(enc, shape, dtype)


class SlotAllocator:
    """Host-side slot management for one tier pool (daemon side).

    ``tenant_quota`` caps how many slots each tenant may hold concurrently.
    ``base`` offsets the initial free list to ``[base, base + capacity)``:
    slots are GLOBAL rows of the shared codec-class buffer, and each pool
    starts with its own contiguous row range of the class partition.
    ``exchange_slots`` may interleave ranges over time.
    """

    def __init__(
        self,
        capacity: int,
        tenant_quota: Optional[Dict[str, int]] = None,
        base: int = 0,
    ):
        self.capacity = capacity
        self.base = base
        if tenant_quota is not None and sum(tenant_quota.values()) > capacity:
            raise ValueError("tenant quotas exceed pool capacity")
        self.tenant_quota = tenant_quota
        self._free: List[int] = list(range(base + capacity - 1, base - 1, -1))
        self._owner: dict[int, int] = {}  # slot -> block_id
        self._slot_tenant: Dict[int, str] = {}
        self._tenant_used: Dict[str, int] = {}

    def alloc(self, block_id: int, tenant: Optional[str] = None) -> int:
        if not self._free:
            raise MemoryError("tier pool exhausted")
        if self.tenant_quota is not None:
            if tenant is None:
                raise ValueError("tenant required when tenant_quota is set")
            if tenant not in self.tenant_quota:
                raise KeyError(f"unknown tenant {tenant!r}")
            if self._tenant_used.get(tenant, 0) >= self.tenant_quota[tenant]:
                raise MemoryError(f"tenant {tenant!r} quota exhausted")
        slot = self._free.pop()
        self._owner[slot] = block_id
        if tenant is not None:
            self._slot_tenant[slot] = tenant
            self._tenant_used[tenant] = self._tenant_used.get(tenant, 0) + 1
        return slot

    def free(self, slot: int) -> None:
        """Release an owned slot back to the free list. Freeing a slot this
        allocator does not own raises (double free or stale page table)."""
        if slot not in self._owner:
            raise KeyError(
                f"free of unowned slot {slot} (double free or stale table?)"
            )
        del self._owner[slot]
        self._free.append(slot)
        tenant = self._slot_tenant.pop(slot, None)
        if tenant is not None:
            self._tenant_used[tenant] -= 1

    @property
    def used(self) -> int:
        return self.capacity - len(self._free)

    def used_by(self, tenant: str) -> int:
        return self._tenant_used.get(tenant, 0)


def exchange_slots(
    src: "SlotAllocator",
    dst: "SlotAllocator",
    slot: int,
    block_id: int,
    tenant: Optional[str] = None,
) -> int:
    """Transfer ownership of physical row ``slot`` from ``src`` to ``dst``
    without moving any payload (same-codec migration in the class-major
    layout). ``dst`` hands one of its free rows back to ``src`` so both
    allocators conserve (free + owned) == capacity. ``dst`` tenant quota is
    enforced like ``alloc``. Returns ``slot`` (the page's row, unchanged)."""
    if slot not in src._owner:
        raise KeyError(f"exchange of slot {slot} not owned by source pool")
    if not dst._free:
        raise MemoryError("tier pool exhausted")
    if dst.tenant_quota is not None:
        if tenant is None:
            raise ValueError("tenant required when tenant_quota is set")
        if tenant not in dst.tenant_quota:
            raise KeyError(f"unknown tenant {tenant!r}")
        if dst._tenant_used.get(tenant, 0) >= dst.tenant_quota[tenant]:
            raise MemoryError(f"tenant {tenant!r} quota exhausted")
    del src._owner[slot]
    st = src._slot_tenant.pop(slot, None)
    if st is not None:
        src._tenant_used[st] -= 1
    src._free.append(dst._free.pop())
    dst._owner[slot] = block_id
    if tenant is not None:
        dst._slot_tenant[slot] = tenant
        dst._tenant_used[tenant] = dst._tenant_used.get(tenant, 0) + 1
    return slot


@dataclasses.dataclass(frozen=True)
class PoolRange:
    """One pool's initial slice of its codec class's shared row space."""

    name: str
    bits: int
    base: int
    capacity: int


class ClassPartition:
    """Codec-class-major row partition over an ordered set of tier pools.

    ``specs`` is an ordered sequence of ``(name, bits, capacity)``; pools of
    the same codec width stack into one shared class buffer, each owning the
    contiguous global-row range ``[base, base + capacity)`` in spec order.
    ``class_rows`` is the total buffer height per codec class (min 1 so an
    empty class still materializes a dummy row for the kernel operands)."""

    def __init__(self, specs: Sequence[Tuple[str, int, int]]):
        self.ranges: Dict[str, PoolRange] = {}
        off: Dict[int, int] = {}
        for name, bits, cap in specs:
            if name in self.ranges:
                raise ValueError(f"duplicate pool name {name!r}")
            b = off.get(int(bits), 0)
            self.ranges[name] = PoolRange(name, int(bits), b, int(cap))
            off[int(bits)] = b + int(cap)
        self._rows = off

    def base(self, name: str) -> int:
        return self.ranges[name].base

    def class_rows(self, bits: int) -> int:
        return max(self._rows.get(int(bits), 0), 1)


class TenantLedger:
    """Per-tenant region accounting + reservations on shared tier pools.

    Tracks, per (tenant, placement index), how many regions the tenant holds
    (``usage``, written by the arbiter each window) and how many it has
    reserved ahead of migration (``reserved``). Capacity is fleet-wide per
    tier; ``headroom``/``oversubscribed`` are what the arbiter's capacity
    reconciliation enforces.
    """

    def __init__(self, tenants: Sequence[str], capacity_regions: np.ndarray):
        self.tenants = list(tenants)
        self._idx = {t: i for i, t in enumerate(self.tenants)}
        if len(self._idx) != len(self.tenants):
            raise ValueError("tenant names must be unique")
        self.capacity = np.asarray(capacity_regions, dtype=np.float64)
        self.usage = np.zeros((len(self.tenants), self.capacity.size), dtype=np.int64)
        self.reserved = np.zeros_like(self.usage)

    def index(self, tenant: str) -> int:
        return self._idx[tenant]

    def set_usage(self, tenant: str, per_tier_regions: np.ndarray) -> None:
        per_tier_regions = np.asarray(per_tier_regions, dtype=np.int64)
        if per_tier_regions.shape != (self.capacity.size,):
            raise ValueError("usage vector must have one entry per placement index")
        self.usage[self._idx[tenant]] = per_tier_regions

    def reserve(self, tenant: str, tier: int, n_regions: int = 1) -> bool:
        """Reserve migration headroom; False when the tier cannot hold it."""
        if self.headroom(tier) < n_regions:
            return False
        self.reserved[self._idx[tenant], tier] += n_regions
        return True

    def release(self, tenant: str, tier: int, n_regions: int = 1) -> None:
        t = self._idx[tenant]
        self.reserved[t, tier] = max(self.reserved[t, tier] - n_regions, 0)

    def headroom(self, tier: int) -> float:
        return float(
            self.capacity[tier] - self.usage[:, tier].sum() - self.reserved[:, tier].sum()
        )

    def tenant_usage(self, tenant: str) -> np.ndarray:
        return self.usage[self._idx[tenant]].copy()

    def oversubscribed(self) -> np.ndarray:
        """Per-tier bool: committed usage + reservations exceed capacity."""
        return (self.usage.sum(axis=0) + self.reserved.sum(axis=0)) > self.capacity


@dataclasses.dataclass
class BlockTable:
    """Host-side block -> (placement, slot) mapping for a managed store."""

    n_blocks: int

    def __post_init__(self):
        self.placement = np.zeros(self.n_blocks, dtype=np.int64)  # 0 = uncompressed
        self.slot = np.full(self.n_blocks, -1, dtype=np.int64)

    def move(self, block_id: int, new_placement: int, new_slot: int) -> Tuple[int, int]:
        old = (int(self.placement[block_id]), int(self.slot[block_id]))
        self.placement[block_id] = new_placement
        self.slot[block_id] = new_slot
        return old
