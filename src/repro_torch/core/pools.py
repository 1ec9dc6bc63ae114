"""Host-side slot management for the compressed device pools.

Mirrors ``SlotAllocator``, ``exchange_slots`` and the codec-class-major
``PoolRange``/``ClassPartition`` of ``repro.core.pools``. Allocation policy
runs on the host (it is part of the daemon tax) and only integer class-row
indices reach the device page tables.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


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
