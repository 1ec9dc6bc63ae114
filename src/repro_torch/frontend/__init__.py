"""Serving frontend: SLA-aware continuous batching over engine replicas,
after ``repro.frontend`` (pure Python and numpy; the engines it drives run
on the card).

``traces`` generates deterministic virtual-time arrivals, ``admission``
holds the SLA classes + token-budget controller, ``router`` load-balances
replicas, and ``scheduler`` runs the lifecycle — including
preemption-to-host-tier and zero-re-prefill resume.
"""

from repro_torch.frontend.admission import (
    ADMIT,
    DEFAULT_CLASSES,
    QUEUE,
    REFUSE,
    AdmissionController,
    SLAClass,
)
from repro_torch.frontend.router import ReplicaRouter
from repro_torch.frontend.scheduler import (
    ContinuousScheduler,
    FrontendStats,
    RequestRecord,
)
from repro_torch.frontend.traces import ArrivalEvent, TraceConfig, digest, generate

__all__ = [
    "ADMIT",
    "QUEUE",
    "REFUSE",
    "AdmissionController",
    "ArrivalEvent",
    "ContinuousScheduler",
    "DEFAULT_CLASSES",
    "FrontendStats",
    "ReplicaRouter",
    "RequestRecord",
    "SLAClass",
    "TraceConfig",
    "digest",
    "generate",
]
