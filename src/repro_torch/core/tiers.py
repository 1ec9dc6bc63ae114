"""Software-defined compressed tiers: (codec x pool x media) combinations.

Mirrors paper §4/§4.1/Table 1-2. A tier is a point in the
(access latency, compression ratio, $/byte) space:

  * codec  — block-quantization algorithm (``core/codecs.py``); the
             lz4/lzo/deflate analogue,
  * pool   — packing layout for compressed blocks:
               ``slab``   — zbud analogue: fixed half-block slots, O(1)
                            addressing, space saving capped at ~2x,
               ``packed`` — zsmalloc analogue: dense byte packing (rounded to
                            128B) + index indirection, best density but
                            higher per-access management cost,
               ``line``   — hardware-managed cache-line layout behind an
                            inline CXL compressor: 64B-aligned lines, no
                            software index, zero pool-management cost,
  * media  — ``hbm`` (on-chip, fast, expensive), ``host`` (host DRAM behind
             PCIe, 1/3 the $/GB — the paper's DRAM-vs-Optane cost ratio), or
             ``cxl`` (expander DRAM behind an inline hardware compressor,
             1/4 the $/GB before the observed line-compression multiplier).

Access latency per block is the sum of media read, pool management, dequant
compute and a fixed fault overhead; these are the ``Lat_T`` terms of Eq. 8.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.core import hw
from repro_torch.core.codecs import CODECS, Codec

PACKED_ALIGN = 128  # packed pool rounds blocks up to 128B
PACKED_INDEX_BYTES = 8  # per-block index entry (offset + tier metadata)
LINE_ALIGN = 64  # hardware line pool stores 64B cache lines


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One software-defined compressed tier."""

    tid: str  # characterization id, e.g. "C7"
    name: str  # e.g. "PK-I4-HB"
    pool: str  # "slab" | "packed"
    codec_name: str  # key into CODECS
    media: str  # "hbm" | "host"
    # Backing-media device binding (key into repro_torch.media.devices.DEVICES).
    # Empty = the default device for this media class (hbm -> on-chip HBM,
    # host -> host DRAM behind PCIe); override to rebind a tier onto CXL or
    # NVMe swap devices without changing its codec/pool identity.
    media_device: str = ""

    @property
    def codec(self) -> Codec:
        return CODECS[self.codec_name]

    @property
    def device(self):
        """Resolved MediaDevice this tier's payloads live on."""
        from repro_torch.media import devices as media_devices

        name = self.media_device or media_devices.DEFAULT_FOR_MEDIA[self.media]
        return media_devices.get(name)

    # -- size accounting ----------------------------------------------------
    def stored_bytes(self, n_elem: int, src_bytes_per_elem: int = 2) -> int:
        """Bytes this tier actually occupies for one block of n_elem."""
        payload = self.codec.payload_bytes(n_elem)
        scales = self.codec.scale_bytes(n_elem)
        src = n_elem * src_bytes_per_elem
        if self.pool == "slab":
            # zbud analogue: slots of src/2 bytes; payload occupies whole
            # slots (=> saving capped at 2x), scales live in a side-car, and
            # pair-fill inefficiency inflates the footprint (hw.SLAB_UTILIZATION).
            slot = max(src // 2, 1)
            n_slots = -(-payload // slot)
            return int(n_slots * slot / hw.SLAB_UTILIZATION) + scales
        if self.pool == "packed":
            aligned = -(-(payload + scales) // PACKED_ALIGN) * PACKED_ALIGN
            return aligned + PACKED_INDEX_BYTES
        if self.pool == "line":
            # Hardware-managed layout: line-aligned payload + scales, no
            # software index (the controller owns line addressing). This is
            # the *nominal* footprint; the inline compressor's observed line
            # narrowing shows up as a measured-ratio override in the TCO
            # model, not here.
            return -(-(payload + scales) // LINE_ALIGN) * LINE_ALIGN
        raise ValueError(f"unknown pool {self.pool!r}")

    def effective_ratio(self, n_elem: int, src_bytes_per_elem: int = 2) -> float:
        return (n_elem * src_bytes_per_elem) / self.stored_bytes(n_elem, src_bytes_per_elem)

    # -- latency model (Eq. 8's Lat_T, in seconds per block access) ---------
    def access_latency_s(self, n_elem: int, src_bytes_per_elem: int = 2) -> float:
        """Latency of one access *operation* decompressing n_elem elements.

        The fixed terms (fault bookkeeping, pool lookup, media setup) are paid
        once per operation regardless of n_elem, so callers should pass the
        actual access granularity (a 4KB-page block, a KV page, or a whole
        2MB region) rather than summing per-block latencies.
        """
        bytes_read = self.stored_bytes(n_elem, src_bytes_per_elem)
        t_media = bytes_read / hw.media_bw(self.media) + hw.MEDIA_FIXED_US[self.media] * 1e-6
        t_pool = hw.POOL_ACCESS_US[self.pool] * 1e-6
        t_dequant = n_elem * self.codec.decode_ops_per_elem / hw.V5E.peak_vpu_elem_ops
        t_fixed = hw.FAULT_FIXED_US * 1e-6
        return t_media + t_pool + t_dequant + t_fixed

    def compress_latency_s(self, n_elem: int, src_bytes_per_elem: int = 2) -> float:
        """Cost to place one block INTO this tier (encode + media write)."""
        bytes_written = self.stored_bytes(n_elem, src_bytes_per_elem)
        t_media = bytes_written / hw.media_bw(self.media) + hw.MEDIA_FIXED_US[self.media] * 1e-6
        t_encode = n_elem * self.codec.encode_ops_per_elem / hw.V5E.peak_vpu_elem_ops
        return t_media + t_encode

    # -- cost model (Eq. 12's (1/C_Ty)*USD_Ty term) --------------------------
    def usd_per_source_byte(self, n_elem: int, src_bytes_per_elem: int = 2) -> float:
        """USD to store one *source* byte in this tier (compressed)."""
        per_byte = hw.COSTS.usd_per_byte(self.media)
        return per_byte / self.effective_ratio(n_elem, src_bytes_per_elem)


# ---------------------------------------------------------------------------
# The 12 characterized tiers (paper §4.1: 12 of the 63 possible combos) and
# the 5 selected for evaluation (paper §4.2 / Table 2).
#
# Naming: pool SL(slab)/PK(packed) - codec F8/I8/I4/I2 - media HB(hbm)/HO(host)
# Paper mapping: zbud->SL zsmalloc->PK | lz4->F8 lzo->I8 zstd->I4 deflate->I2
#                DRAM->HB Optane->HO
# ---------------------------------------------------------------------------

_T = TierSpec
CHARACTERIZED: List[TierSpec] = [
    _T("C1", "SL-F8-HB", "slab", "fp8", "hbm"),
    _T("C2", "SL-F8-HO", "slab", "fp8", "host"),
    _T("C3", "PK-F8-HB", "packed", "fp8", "hbm"),
    _T("C4", "PK-F8-HO", "packed", "fp8", "host"),
    _T("C5", "SL-I8-HB", "slab", "int8", "hbm"),
    _T("C6", "PK-I8-HB", "packed", "int8", "hbm"),
    _T("C7", "PK-I8-HO", "packed", "int8", "host"),
    _T("C8", "SL-I4-HB", "slab", "int4", "hbm"),
    _T("C9", "PK-I4-HB", "packed", "int4", "hbm"),
    _T("C10", "PK-I4-HO", "packed", "int4", "host"),
    _T("C11", "PK-I2-HB", "packed", "int2", "hbm"),
    _T("C12", "PK-I2-HO", "packed", "int2", "host"),
]

# Extension tiers beyond the paper's characterized 12 (registered in the
# id lookup but kept out of ``characterized()`` so the paper tables stay the
# paper's). X1 is the hardware-compressed CXL expander (ZeroPoint-style):
# line pool + inline hw codec on cxl media. It sits between C1 (fast,
# expensive HBM) and C2 (cheap but PCIe-latency host) on the latency axis,
# and below both on $/GB once the observed line ratio multiplies effective
# capacity.
EXTENSION: List[TierSpec] = [
    _T("X1", "LN-HW-CX", "line", "cxl_hw", "cxl", media_device="cxl_hw"),
]
_BY_ID = {t.tid: t for t in CHARACTERIZED + EXTENSION}


def characterized() -> List[TierSpec]:
    return list(CHARACTERIZED)


def get(tid: str) -> TierSpec:
    return _BY_ID[tid]


# Paper Table 2 analogue. Selection rationale (§4.2):
#   T1 = C1  best-performance config           (paper: ZB-L4-DR)
#   T2 = C2  lowest-latency cheap-media tier   (paper: ZB-L4-OP)
#   T3 = C4  fast codec + dense pool + cheap   (paper: ZS-L4-OP)
#   T4 = C9  latency/TCO gap filler on HBM     (paper: ZS-LO-DR)
#   T5 = C12 best memory-TCO savings config    (paper: ZS-DE-OP)
SELECTED_IDS = ("C1", "C2", "C4", "C9", "C12")


def selected() -> List[TierSpec]:
    return [_BY_ID[i] for i in SELECTED_IDS]


# The paper's 2-Tier baseline: Google's production config — zsmalloc + lzo
# backed by DRAM [36] => packed + int8 + hbm.
BASELINE_2T = _BY_ID["C6"]


@dataclasses.dataclass(frozen=True)
class TierSet:
    """DRAM/HBM (uncompressed, index 0) + N ordered compressed tiers.

    Tiers are ordered low-latency -> high-TCO-savings (paper §5). Placement
    vectors index into this set: 0 = uncompressed, 1..N = tiers[i-1].
    """

    tiers: Sequence[TierSpec]
    block_elems: int = 2048  # elements per managed block (4KB bf16 page)
    src_bytes_per_elem: int = 2

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    @property
    def block_bytes(self) -> int:
        return self.block_elems * self.src_bytes_per_elem

    def latencies_s(self):
        """Lat_T per placement index (index 0 = DRAM = 0 overhead)."""
        return [0.0] + [t.access_latency_s(self.block_elems, self.src_bytes_per_elem) for t in self.tiers]

    def usd_per_source_byte(self):
        """$/source-byte per placement index (index 0 = uncompressed HBM)."""
        hbm = hw.COSTS.usd_per_byte("hbm")
        return [hbm] + [t.usd_per_source_byte(self.block_elems, self.src_bytes_per_elem) for t in self.tiers]

    def ratios(self):
        return [1.0] + [t.effective_ratio(self.block_elems, self.src_bytes_per_elem) for t in self.tiers]

    def media_devices(self):
        """MediaDevice per placement index (index 0 = uncompressed on-chip)."""
        from repro_torch.media import devices as media_devices

        return [media_devices.get("hbm")] + [t.device for t in self.tiers]

    def indices_for_device(self, device_name: str) -> List[int]:
        """Placement indices whose tiers live on ``device_name`` — the unit
        of quarantine: a down device takes *all* of its tiers off the
        placement frontier at once (e.g. both host tiers share one PCIe
        link)."""
        return [
            i
            for i, d in enumerate(self.media_devices())
            if d.name == device_name
        ]


def default_tierset(block_elems: int = 2048) -> TierSet:
    """DRAM + the 5 selected tiers (the paper's 6T evaluation config)."""
    return TierSet(tiers=tuple(selected()), block_elems=block_elems)


def baseline_2t_tierset(block_elems: int = 2048) -> TierSet:
    """DRAM + single compressed tier (Google production config [36])."""
    return TierSet(tiers=(BASELINE_2T,), block_elems=block_elems)


# 6T + the hardware-compressed CXL expander, ordered low-latency ->
# high-TCO-savings: X1 slots in right after C1 (its inline decode makes it
# faster than every host tier despite the expander hop).
CXL_SELECTED_IDS = ("C1", "X1", "C2", "C4", "C9", "C12")


def cxl_tierset(block_elems: int = 2048) -> TierSet:
    """DRAM + the 5 selected tiers + the cxl_hw tier (7T evaluation config)."""
    return TierSet(
        tiers=tuple(_BY_ID[i] for i in CXL_SELECTED_IDS), block_elems=block_elems
    )
