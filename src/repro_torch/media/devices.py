"""Backing-media device catalog and deterministic queue/bandwidth model,
after ``repro.media.devices``.

A ``MediaDevice`` is the third axis of a software-defined tier (codec x
pool x media): the physical thing a compressed payload is read from and
written to. The cost model is the standard DMA-engine abstraction:

  service_time(bytes) = fixed_latency + bytes / bandwidth

with ``queue_depth`` concurrent channels. ``MediaQueue`` evaluates it in
*virtual time* (callers supply ``now``; nothing here reads a clock), so the
accounting is bit-deterministic and equal to the reference's for the same
submissions. The bandwidths and latencies are the reference's modeled
parameters (``core/hw.py``: the ``V5E`` host link, CXL and NVMe constants);
busy seconds from these queues are modeled time that places pages, never a
measurement of the card the port runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core import hw


@dataclasses.dataclass(frozen=True)
class MediaDevice:
    """One backing-media device class and its transfer cost model."""

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

    def service_time_s(self, n_bytes: int, write: bool = False) -> float:
        """Uncontended transfer time for one op of ``n_bytes``."""
        bw = self.write_bw if write else self.read_bw
        return self.fixed_latency_s + n_bytes / bw

    def batch_service_time_s(
        self, n_bytes: int, ops: int = 1, write: bool = False
    ) -> float:
        """Uncontended transfer time for ``ops`` operations totalling
        ``n_bytes`` (each op pays the fixed setup cost): the formula
        ``MediaQueue.submit`` charges."""
        bw = self.write_bw if write else self.read_bw
        return ops * self.fixed_latency_s + n_bytes / bw


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
        # The same expander behind an inline line compressor: nominal link
        # numbers here; ``make_queues`` wraps it in an ``AdaptiveMediaDevice``.
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

# Catalog names ``make_queues`` instantiates as compressibility-adaptive.
ADAPTIVE_DEVICES = frozenset({"cxl_hw"})


class AdaptiveMediaDevice:
    """A ``MediaDevice`` whose effective bandwidth tracks data
    compressibility (an inline hardware compressor on the link: effective
    bandwidth = base link rate x committed ratio).

    ``observe`` only accumulates encoded sizes; ``commit_window`` folds them
    into the committed ratio by an EWMA at the window boundary, the only
    point where a service time may move."""

    def __init__(self, base: MediaDevice, init_ratio: float = 1.0, ema: float = 0.25):
        if init_ratio < 1.0:
            raise ValueError("init_ratio must be >= 1.0")
        self.base = base
        self.ratio = float(init_ratio)
        self.ema = float(ema)
        self._pending_nominal = 0.0
        self._pending_wire = 0.0

    @property
    def name(self) -> str:
        return self.base.name

    @property
    def read_bw(self) -> float:
        return self.base.read_bw * self.ratio

    @property
    def write_bw(self) -> float:
        return self.base.write_bw * self.ratio

    @property
    def fixed_latency_s(self) -> float:
        return self.base.fixed_latency_s

    @property
    def queue_depth(self) -> int:
        return self.base.queue_depth

    def service_time_s(self, n_bytes: int, write: bool = False) -> float:
        bw = self.write_bw if write else self.read_bw
        return self.fixed_latency_s + n_bytes / bw

    def batch_service_time_s(
        self, n_bytes: int, ops: int = 1, write: bool = False
    ) -> float:
        bw = self.write_bw if write else self.read_bw
        return ops * self.fixed_latency_s + n_bytes / bw

    def observe(self, nominal_bytes: float, wire_bytes: float) -> None:
        """Record encoded sizes seen mid-window (no effect until commit)."""
        if nominal_bytes < 0 or wire_bytes < 0:
            raise ValueError("observed byte counts must be non-negative")
        self._pending_nominal += float(nominal_bytes)
        self._pending_wire += float(wire_bytes)

    def commit_window(self) -> float:
        """Window-boundary EWMA fold of the pending observation; returns the
        (possibly unchanged) committed ratio."""
        if self._pending_wire > 0.0:
            observed = max(self._pending_nominal / self._pending_wire, 1.0)
            self.ratio = (1.0 - self.ema) * self.ratio + self.ema * observed
        self._pending_nominal = 0.0
        self._pending_wire = 0.0
        return self.ratio


def get(name: str) -> MediaDevice:
    try:
        return DEVICES[name]
    except KeyError:
        raise KeyError(
            f"unknown media device {name!r}; catalog: {sorted(DEVICES)}"
        ) from None


class MediaQueue:
    """Virtual-time transfer queue for one device: ``submit`` places a
    transfer on the earliest-free of ``queue_depth`` channels; cumulative
    ``busy_s`` / ``bytes_total`` / ``queue_wait_s`` are the per-device
    charges the manager's contention feedback reads."""

    def __init__(self, device: MediaDevice):
        self.device = device
        self._channels: List[float] = [0.0] * device.queue_depth
        self.busy_s = 0.0
        self.queue_wait_s = 0.0
        self.bytes_total = 0
        self.ops = 0

    def submit(
        self, n_bytes: int, now: float = 0.0, write: bool = False, ops: int = 1
    ) -> Tuple[float, float]:
        """Charge one aggregate transfer of ``n_bytes`` spanning ``ops``
        device operations; returns (start_s, done_s)."""
        svc = self.device.batch_service_time_s(n_bytes, ops=ops, write=write)
        ch = min(range(len(self._channels)), key=lambda i: self._channels[i])
        start = max(now, self._channels[ch])
        done = start + svc
        self._channels[ch] = done
        self.busy_s += svc
        self.queue_wait_s += start - now
        self.bytes_total += int(n_bytes)
        self.ops += ops
        return start, done

    def utilization(self, elapsed_s: float) -> float:
        """Fraction of one channel's time spent transferring (can exceed 1
        on multi-channel devices under heavy load; callers clip)."""
        return self.busy_s / max(elapsed_s, 1e-30)


def make_queues(names) -> Dict[str, MediaQueue]:
    """One MediaQueue per distinct device name; adaptive catalog entries get
    a fresh ``AdaptiveMediaDevice`` per queue set."""
    queues: Dict[str, MediaQueue] = {}
    for n in dict.fromkeys(names):
        dev = get(n)
        if n in ADAPTIVE_DEVICES:
            dev = AdaptiveMediaDevice(dev)
        queues[n] = MediaQueue(dev)
    return queues


def adaptive_devices(queues: Dict[str, MediaQueue]) -> Dict[str, AdaptiveMediaDevice]:
    """The adaptive devices of a queue set, by name, seen through a fault
    wrapper's ``.base``."""
    out: Dict[str, AdaptiveMediaDevice] = {}
    for n, q in queues.items():
        dev = q.device
        if not isinstance(dev, AdaptiveMediaDevice):
            dev = getattr(dev, "base", None)
        if isinstance(dev, AdaptiveMediaDevice):
            out[n] = dev
    return out
