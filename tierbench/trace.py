"""Reading a profiled slice: device intervals, busy and idle time, kernel
times by name, and the longest idle gaps labelled by the harness's own host
span (``tierbench.<call>``) that was open at the gap's middle.

Works on the Chrome trace ``torch.profiler`` exports: complete events
(``"ph": "X"``) of category ``kernel``, ``gpu_memcpy`` or ``gpu_memset`` are
device work; ``user_annotation`` events are the harness's spans. Times in
the file are microseconds on one clock.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "tierbench."
SLICE = "tierbench.slice"

# Kernel #1, the fused tiered decode attention, and kernel #2, page-out
# quantization from bf16 (``row_group::rows_kernel`` over ``Rows`` with a
# bf16 source; transcode reads int8/int4 and dequant is ``DequantRows``).
ATTENTION = re.compile(r"fused_tiered_attention_kernel")
QUANT_BF16 = re.compile(r"(?<!Dequant)Rows<\s*(\(row_group::Src\)1|row_group::Src::BF16)\s*,")


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]  # seconds, the slice's host span
    device: List[Tuple[float, float, str]]  # (start, end, name) in seconds
    spans: List[Tuple[float, float, str]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Union of device intervals within the window."""
        return sum(b - a for a, b in self._union())

    def _union(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        out: List[List[float]] = []
        for a, b, _ in sorted(self.device):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def kernel_seconds(self, pattern: re.Pattern) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name matches."""
        hits = [b - a for a, b, n in self.device if pattern.search(n)]
        return float(sum(hits)), len(hits)

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for a, b, n in self.device:
            by[n] = by.get(n, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda x: -x[1])[:k]
        return [[_short(n), s] for n, s in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest stretches of the window with no device work,
        each named by the innermost harness span open at its middle."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self._union() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            open_ = [s for s in self.spans if s[0] <= mid <= s[1] and s[2] != SLICE]
            name = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "harness"
            out.append([name, b - a])
        return out


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def read(path: str) -> Optional[Trace]:
    """The slice of a Chrome trace, or None when it holds no slice span."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    device, spans = [], []
    window = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            device.append((a, b, name))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((a, b, name))
            if name == SLICE:
                window = (a, b)
    if window is None:
        return None
    return Trace(window=window, device=device, spans=spans)
