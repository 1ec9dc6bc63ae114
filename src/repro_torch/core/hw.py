"""Hardware constants of the placement model (copied from ``repro.core.hw``).

The tier cost model (``core/tiers.py``), the TCO model (``core/tco.py``) and
the media catalog (``media/devices.py``) price tiers with these published
part specs of the JAX package's target platform (TPU v5e) and its host. The
port keeps them unchanged so that its ``TierScapeManager`` plans are
bit-identical to the reference's; they are model inputs, not measurements of
the GPU the port runs on.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip specs for the compute platform."""

    name: str = "tpu-v5e"
    # Compute.
    peak_bf16_flops: float = 197e12  # 197 TFLOP/s bf16 per chip.
    # Effective element-ops/s on the *fault path*: an on-demand dequant is a
    # blocking, launch-bound op (dispatch + no cross-block pipelining), so it
    # sees a small fraction of nominal VPU throughput. This constant is what
    # makes high-ratio codecs the slowest tiers (deflate's role in Fig 3a).
    # Bulk dequant inside the tiered-attention kernel is NOT subject to this —
    # it pipelines across blocks and is accounted by the roofline instead.
    peak_vpu_elem_ops: float = 0.1e12
    # Memory.
    hbm_bytes: int = 16 * 1024**3  # 16 GiB HBM per chip.
    hbm_bw: float = 819e9  # 819 GB/s HBM bandwidth.
    vmem_bytes: int = 128 * 1024**2  # ~128 MiB VMEM (v5e: 128MB total).
    # Interconnect.
    ici_link_bw: float = 50e9  # ~50 GB/s per ICI link (given constant).
    ici_links: int = 4  # 2D torus on v5e.
    # Host attachment.
    host_link_bw: float = 25e9  # effective PCIe Gen4 x16 per chip-host path.
    host_dram_bytes: int = 512 * 1024**3


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """Unit memory cost (relative USD units; only ratios matter).

    The paper (§7.2) sets the per-GB cost of Optane at 1/3 of DRAM [43]. We
    keep the identical ratio between the accelerator-attached tier (HBM) and
    the host-DRAM tier behind PCIe.
    """

    usd_per_gb_hbm: float = 10.0
    usd_per_gb_host: float = 10.0 / 3.0
    # CXL-attached expander DRAM: commodity DIMMs behind a CXL controller,
    # priced below the host tier (no per-chip PCIe lane budget, denser
    # modules). The ZeroPoint-style inline compressor multiplies *effective*
    # $/byte down further via the tier's measured ratio — that part lives in
    # the TCO model, not here.
    usd_per_gb_cxl: float = 10.0 / 4.0

    def usd_per_byte(self, media: str) -> float:
        if media == "hbm":
            return self.usd_per_gb_hbm / 1024**3
        if media == "host":
            return self.usd_per_gb_host / 1024**3
        if media == "cxl":
            return self.usd_per_gb_cxl / 1024**3
        raise ValueError(f"unknown media {media!r}")


V5E = ChipSpec()
COSTS = CostSpec()

# Fixed software overhead charged per fault (engine bookkeeping: page-table
# style lookup of the block handle, launch overhead of the dequant op). The
# analogue of the kernel fault-path cost in the paper.
FAULT_FIXED_US: float = 1.0

# Pool-manager overhead per access operation (µs). ``slab`` mirrors zbud
# (simple O(1) slot addressing); ``packed`` mirrors zsmalloc (dense packing,
# extra index indirection + unaligned gather); ``line`` is the
# hardware-managed layout behind an inline CXL compressor — the controller
# owns line addressing, so the software pool manager charges nothing.
POOL_ACCESS_US = {"slab": 0.2, "packed": 0.8, "line": 0.0}

# Fixed media-access setup cost per access operation (µs): HBM reads go out
# directly; host reads pay PCIe DMA setup + link round-trip (the Optane
# media-latency analogue of paper §4.1.1); CXL.mem loads are cache-line
# transactions, cheaper to set up than a PCIe DMA descriptor.
MEDIA_FIXED_US = {"hbm": 0.0, "host": 2.0, "cxl": 0.6}

# zbud-analogue pair-fill inefficiency: two variable-fit objects per slab
# page achieve < 100% slot utilization in practice (paper: zbud saving
# "cannot be more than 50%", typically less). Packed (zsmalloc) pools do not
# pay this, which is why they win on density.
SLAB_UTILIZATION = 0.85

# Per-element decode cost in VPU element-ops for each codec (unpack, shift,
# scale-multiply, cast chains). Mirrors lz4 < lzo < deflate decode cost.
# ``cxl_hw`` decompresses inline in the memory controller (ZeroPoint-style):
# the VPU only pays a residual scale-apply, near-zero ops/elem.
CODEC_DECODE_OPS = {
    "none": 0.0, "fp8": 1.0, "int8": 2.0, "int4": 4.0, "int2": 6.0,
    "cxl_hw": 0.1,
}
# Encode cost (abs-max reduce + divide + round + pack). The hardware codec's
# line packing happens in the controller; software only quantizes.
CODEC_ENCODE_OPS = {
    "none": 0.0, "fp8": 1.5, "int8": 3.0, "int4": 5.0, "int2": 7.0,
    "cxl_hw": 0.2,
}

# --------------------------------------------------------------------------
# Media-device link specs shared by the MediaDevice presets
# (``media/devices.py``) and anything else that prices far-memory traffic.
# One definition per number — the presets must never fork these.
# --------------------------------------------------------------------------
# CXL 2.0 x8 expander: asymmetric effective read/write, cache-line
# transaction setup, controller-level parallelism.
CXL_LINK_READ_BW: float = 64e9
CXL_LINK_WRITE_BW: float = 48e9
CXL_FIXED_LATENCY_S: float = MEDIA_FIXED_US["cxl"] * 1e-6
CXL_QUEUE_DEPTH: int = 8
# Datacenter NVMe (PCIe Gen4 drive).
NVME_READ_BW: float = 7e9
NVME_WRITE_BW: float = 5e9
NVME_FIXED_LATENCY_S: float = 10e-6
NVME_QUEUE_DEPTH: int = 32


def media_bw(media: str, chip: ChipSpec = V5E) -> float:
    """Effective read bandwidth for a tier's backing media."""
    if media == "hbm":
        return chip.hbm_bw
    if media == "host":
        return chip.host_link_bw
    if media == "cxl":
        return CXL_LINK_READ_BW
    raise ValueError(f"unknown media {media!r}")
