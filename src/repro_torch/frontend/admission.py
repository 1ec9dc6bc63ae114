"""SLA classes + token-budget admission control for the serving frontend,
after ``repro.frontend.admission``.

The controller is a PURE decision function over live engine headroom: the
scheduler feeds it the fleet's token capacity, outstanding commitments
(resident context + ungenerated remainder + queued projections) and live
device-tier headroom, all read from ``TieredEngine``/``TieredKVCache``
accessors each step. Admission never lets a class push the fleet past its
token-budget share — requests queue or are refused instead of OOMing the
pools — and per-class queue caps bound the worst-case queue delay.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from repro_torch.frontend.traces import ArrivalEvent

ADMIT = "admit"  # place now (free slot + device headroom for the prompt)
QUEUE = "queue"  # hold in the frontend queue; placement pass retries
REFUSE = "refuse"  # would break the class token budget / queue cap


@dataclasses.dataclass(frozen=True)
class SLAClass:
    """One service class. ``weight`` orders both placement priority and
    preemption (a class may only preempt strictly lighter victims);
    ``budget_frac`` is the fleet token-residency share past which this
    class's arrivals are refused (heavier classes get the larger share);
    ``ttft_target_steps`` is the SLO target the reports grade against."""

    name: str
    weight: float = 1.0
    ttft_target_steps: int = 64
    budget_frac: float = 0.9
    max_queue: int = 64
    preemptible: bool = True


# Default two-class mix: bulk batch traffic fills slots cheaply and yields
# them to the tight-TTFT interactive class, which may preempt but never be
# preempted.
DEFAULT_CLASSES: Tuple[SLAClass, ...] = (
    SLAClass("batch", weight=0.5, ttft_target_steps=256, budget_frac=0.75,
             max_queue=256, preemptible=True),
    SLAClass("interactive", weight=2.0, ttft_target_steps=24, budget_frac=1.0,
             max_queue=16, preemptible=False),
)


class AdmissionController:
    """Token-budget admission over one or more engine replicas."""

    def __init__(self, classes: Sequence[SLAClass] = DEFAULT_CLASSES):
        if not classes:
            raise ValueError("need at least one SLA class")
        self.classes = tuple(classes)

    def projected_tokens(self, event: ArrivalEvent) -> int:
        return int(event.prompt_len) + int(event.max_new_tokens)

    def decide(
        self,
        event: ArrivalEvent,
        *,
        capacity_tokens: int,
        outstanding_tokens: int,
        headroom_tokens: int,
        free_slot: bool,
        queued_of_class: int,
    ) -> str:
        """Admission decision for one arrival against live fleet state.

        ``capacity_tokens``/``outstanding_tokens`` come from the engines'
        token accounting, ``headroom_tokens`` from the live device-pool free
        lists, ``free_slot`` from the routed replica, ``queued_of_class``
        from the frontend queue. Refusal is load shedding; queueing is
        backpressure; admission starts the request this step."""
        cls = self.classes[event.sla]
        projected = self.projected_tokens(event)
        if queued_of_class >= cls.max_queue:
            return REFUSE
        if outstanding_tokens + projected > cls.budget_frac * capacity_tokens:
            return REFUSE
        if free_slot and projected <= headroom_tokens:
            return ADMIT
        return QUEUE
