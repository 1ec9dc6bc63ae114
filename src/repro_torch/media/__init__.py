"""Backing media of the tiers: software-defined swap devices.

  * ``devices``  — the ``MediaDevice`` catalog (HBM, host-DRAM-over-PCIe,
    CXL, NVMe) with a bandwidth / queue-depth / fixed-latency cost model and
    a deterministic virtual-time ``MediaQueue`` for contention accounting,
  * ``ringbuf``  — the pinned staging ring through which all host-tier
    payloads transit (watermark-based credit flow),
  * ``pipeline`` — the async, double-buffered migration pipeline that splits
    migration cohorts into stage -> transcode -> commit phases and overlaps
    them with engine decode steps,
  * ``faults``   — deterministic, window-keyed fault injection via a
    ``FaultyMediaDevice`` wrapper that keeps replay bit-deterministic.

Importing this package builds nothing and touches no GPU.
"""

from repro_torch.media.devices import (  # noqa: F401
    DEFAULT_FOR_MEDIA,
    DEVICES,
    MediaDevice,
    MediaQueue,
    get,
)
from repro_torch.media.faults import (  # noqa: F401
    MAX_STAGE_RETRIES,
    FaultEvent,
    FaultPlan,
    FaultyMediaDevice,
    default_plan,
)
from repro_torch.media.pipeline import MigrationPipeline  # noqa: F401
from repro_torch.media.ringbuf import PinnedRing  # noqa: F401
