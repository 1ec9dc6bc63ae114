"""Backing-media device catalog (the third axis of a software-defined tier).

Mirrors the catalog half of ``repro.media.devices``: ``MediaDevice``, the
presets, ``DEFAULT_FOR_MEDIA`` and ``get``. ``TierSet.media_devices`` and the
``TierScapeManager`` read it to bill migration traffic per device. The
virtual-time ``MediaQueue``, the adaptive (inline-compressed) device and the
async migration pipeline belong to the media slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import hw


@dataclasses.dataclass(frozen=True)
class MediaDevice:
    """One backing-media device class and its transfer cost parameters
    (the manager bills ``fixed_latency_s + bytes / bandwidth`` per op)."""

    name: str
    read_bw: float  # sustained B/s
    write_bw: float  # sustained B/s
    fixed_latency_s: float  # per-op setup (DMA descriptor / doorbell / link RTT)
    queue_depth: int  # concurrent in-flight transfers the device sustains

    def __post_init__(self):
        if self.read_bw <= 0 or self.write_bw <= 0:
            raise ValueError("bandwidth must be positive")
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")


DEVICES: Dict[str, MediaDevice] = {
    d.name: d
    for d in (
        MediaDevice("hbm", hw.V5E.hbm_bw, hw.V5E.hbm_bw, 0.0, queue_depth=8),
        MediaDevice(
            "host_dram_pcie",
            hw.V5E.host_link_bw,
            hw.V5E.host_link_bw,
            hw.MEDIA_FIXED_US["host"] * 1e-6,
            queue_depth=4,
        ),
        MediaDevice(
            "cxl",
            hw.CXL_LINK_READ_BW,
            hw.CXL_LINK_WRITE_BW,
            hw.CXL_FIXED_LATENCY_S,
            queue_depth=hw.CXL_QUEUE_DEPTH,
        ),
        MediaDevice(
            "cxl_hw",
            hw.CXL_LINK_READ_BW,
            hw.CXL_LINK_WRITE_BW,
            hw.CXL_FIXED_LATENCY_S,
            queue_depth=hw.CXL_QUEUE_DEPTH,
        ),
        MediaDevice(
            "nvme",
            hw.NVME_READ_BW,
            hw.NVME_WRITE_BW,
            hw.NVME_FIXED_LATENCY_S,
            queue_depth=hw.NVME_QUEUE_DEPTH,
        ),
    )
}

# Media string (TierSpec.media) -> default device binding.
DEFAULT_FOR_MEDIA: Dict[str, str] = {
    "hbm": "hbm",
    "host": "host_dram_pcie",
    "cxl": "cxl_hw",
}


def get(name: str) -> MediaDevice:
    try:
        return DEVICES[name]
    except KeyError:
        raise KeyError(
            f"unknown media device {name!r}; catalog: {sorted(DEVICES)}"
        ) from None
