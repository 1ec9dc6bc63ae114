"""Pinned staging ring buffer with watermark-based credit flow, after
``repro.media.ringbuf``.

Host-tier payloads transit a page-locked staging arena that the copy engine
reads and writes; slots are recycled under a credit protocol so a slow
consumer back-pressures the producer. The arena is one ``uint8`` tensor of
``[n_slots, slot_bytes]``, pinned when the cache lives on a CUDA device.

  * producers ``try_acquire`` slot credits and ``stage_rows`` bytes into
    them; consumers ``view`` and ``release``;
  * demand credits are watermark-hysteretic: when free credits fall to the
    low watermark the ring refuses new acquisitions until frees climb back
    to the high watermark;
  * speculative credits (the prefetch path) are capped to a reserved slice
    and refused whenever granting them would drop free credits below the
    high watermark, so speculation never starves a demand migration.

Invariants: free + held == n_slots; a slot is never handed out twice;
double release raises.

A row staged from a CUDA tensor is a device-to-host copy into pinned
memory. ``stage_rows`` makes it a blocking copy, so the bytes are in the
arena when it returns and a CRC taken right after sees them, never stale
ones.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


class PinnedRing:
    def __init__(
        self,
        n_slots: int,
        slot_bytes: int,
        low_watermark: float = 0.125,
        high_watermark: float = 0.5,
        spec_reserve: float = 0.25,
        pin: bool = False,
    ):
        if n_slots < 1 or slot_bytes < 1:
            raise ValueError("ring needs at least one slot of at least one byte")
        if not 0.0 <= low_watermark < high_watermark <= 1.0:
            raise ValueError("need 0 <= low_watermark < high_watermark <= 1")
        if not 0.0 <= spec_reserve <= 1.0:
            raise ValueError("need 0 <= spec_reserve <= 1")
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes
        self.buf = torch.zeros((n_slots, slot_bytes), dtype=torch.uint8, pin_memory=pin)
        self._fill = np.zeros(n_slots, dtype=np.int64)  # valid bytes per slot
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self._held: set = set()
        self.low_slots = int(np.floor(low_watermark * n_slots))
        self.high_slots = max(int(np.ceil(high_watermark * n_slots)), self.low_slots + 1)
        self.backpressured = False
        self.spec_slots = int(np.floor(spec_reserve * n_slots))
        self._spec_held: set = set()
        self.acquires = 0
        self.stalls = 0
        self.spec_acquires = 0
        self.spec_rejects = 0

    # ------------------------------------------------------------- credits
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def held_slots(self) -> int:
        return len(self._held)

    def can_acquire(self, n: int) -> bool:
        if self.backpressured:
            return False
        return n <= len(self._free)

    @property
    def spec_held_slots(self) -> int:
        return len(self._spec_held)

    def try_acquire(self, n: int, speculative: bool = False) -> Optional[List[int]]:
        """Claim ``n`` slot credits, or None under backpressure / shortage
        (demand) or when the reserved slice or the high watermark refuses
        them (speculative, which never engages backpressure)."""
        if speculative:
            self.spec_acquires += 1
            if (
                self.backpressured
                or len(self._spec_held) + n > self.spec_slots
                or len(self._free) - n < self.high_slots
            ):
                self.spec_rejects += 1
                return None
            slots = [self._free.pop() for _ in range(n)]
            self._held.update(slots)
            self._spec_held.update(slots)
            return slots
        self.acquires += 1
        if self.backpressured or n > len(self._free):
            if n <= self.n_slots:  # a satisfiable request blocked on credits
                self.stalls += 1
            if n > len(self._free):
                self.backpressured = True
            return None
        slots = [self._free.pop() for _ in range(n)]
        self._held.update(slots)
        if len(self._free) <= self.low_slots:
            self.backpressured = True
        return slots

    def release(self, slots: Sequence[int]) -> None:
        for s in slots:
            if s not in self._held:
                raise ValueError(f"slot {s} released without being held")
            self._held.discard(s)
            self._spec_held.discard(s)
            self._fill[s] = 0
            self._free.append(s)
        if self.backpressured and len(self._free) >= self.high_slots:
            self.backpressured = False

    # ---------------------------------------------------------------- data
    def _check_held(self, slot: int, what: str) -> None:
        if slot not in self._held:
            raise ValueError(f"{what} unheld slot {slot}")

    def stage_rows(self, slots: Sequence[int], rows: torch.Tensor) -> None:
        """Copy ``rows`` [len(slots), n] uint8 (on any device) into held
        slots with one blocking copy."""
        for s in slots:
            self._check_held(s, "stage into")
        n = int(rows.shape[1])
        if n > self.slot_bytes:
            raise ValueError(f"payload of {n}B exceeds slot size {self.slot_bytes}B")
        host = rows.to("cpu", non_blocking=False)
        idx = torch.as_tensor(list(slots), dtype=torch.int64)
        self.buf[idx, :n] = host
        self._fill[list(slots)] = n

    def view(self, slot: int) -> torch.Tensor:
        """The valid bytes of a held slot (a view of the arena)."""
        self._check_held(slot, "read from")
        return self.buf[slot, : int(self._fill[slot])]
