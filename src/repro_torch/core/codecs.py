"""Block-quantization codec metadata: the fixed ratios and modeled decode
costs that ``tiers.py`` and ``tco.py`` price tiers with.

Mirrors the ``Codec`` table of ``repro.core.codecs``. Only the metadata is
here: the KV-page quantization the serving path runs lives in
``repro_torch.kernels`` (``quant_page`` / ``transcode_page`` and their plain
versions in ``kernels/ref.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import hw

# Group sizes for per-group absmax scaling (elements sharing one f32 scale).
GROUP = {"int8": 128, "int4": 64, "int2": 32, "cxl_hw": 512}
SCALE_BYTES = 4  # f32 scales


@dataclasses.dataclass(frozen=True)
class Codec:
    """A compression algorithm: fixed ratio, fixed decode cost/elem."""

    name: str
    bits_per_elem: float  # payload bits per source element (excl. scales)
    group: int  # elements per f32 scale (0 = one scale per block)

    def payload_bytes(self, n_elem: int) -> int:
        return int(n_elem * self.bits_per_elem) // 8

    def scale_bytes(self, n_elem: int) -> int:
        if self.name == "none":
            return 0
        n_groups = 1 if self.group == 0 else (n_elem + self.group - 1) // self.group
        return n_groups * SCALE_BYTES

    def compressed_bytes(self, n_elem: int) -> int:
        return self.payload_bytes(n_elem) + self.scale_bytes(n_elem)

    def ratio(self, n_elem: int, src_bytes_per_elem: int = 2) -> float:
        if self.name == "none":
            return 1.0
        return (n_elem * src_bytes_per_elem) / self.compressed_bytes(n_elem)

    @property
    def decode_ops_per_elem(self) -> float:
        return hw.CODEC_DECODE_OPS[self.name]

    @property
    def encode_ops_per_elem(self) -> float:
        return hw.CODEC_ENCODE_OPS[self.name]


CODECS: Dict[str, Codec] = {
    "none": Codec("none", 16.0, 0),
    "fp8": Codec("fp8", 8.0, 0),
    "int8": Codec("int8", 8.0, GROUP["int8"]),
    "int4": Codec("int4", 4.0, GROUP["int4"]),
    "int2": Codec("int2", 2.0, GROUP["int2"]),
    "cxl_hw": Codec("cxl_hw", 8.0, GROUP["cxl_hw"]),
}
