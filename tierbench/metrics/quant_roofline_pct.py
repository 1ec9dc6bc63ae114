"""Kernels: page-out quantization from bf16 (kernel #2) against its byte
bound. Bytes: ``counts.quant_bytes`` of every page that entered the cache
during the traced slice (a prefill's pages, and the pages each decode step
moved out of a recent window), at the codec width it was first seen in;
time: the kernel's device time in the traced slice."""

import numpy as np

from tierbench import counts, families, peaks, trace
from tierbench.harness import COLD, HOST4, HOST8, INFLIGHT, WARM


def _occupants(res, k):
    """Slot -> request before engine step ``k`` (after the slice: the
    requests left in their slots)."""
    drv = res.drv
    i = k - drv.base
    if i < len(drv.step_slots):
        slots, _, recs = drv.step_slots[i]
        return dict(zip(slots.tolist(), recs))
    return {r.slot: r for r in res.slice_live}


def read(res):
    tr = res.trace
    if tr is None:
        return None
    secs, launches = tr.kernel_seconds(trace.QUANT_BF16)
    if launches == 0 or secs <= 0:
        return None
    conf = res.cell.conf
    m = families.of(conf).shape(conf)
    t = conf["tiering"]
    pt = int(t["page_tokens"])
    bits = {WARM: int(t["warm_bits"]), COLD: int(t["cold_bits"]), HOST8: 8, HOST4: 4,
            INFLIGHT: 8}
    drv = res.drv
    first, last = res.slice_steps
    total = 0
    for k in range(first, last):
        before, after = drv.levels_at(k), drv.levels_at(k + 1)
        was, now = _occupants(res, k), _occupants(res, k + 1)
        for slot, r in now.items():
            a = after[:, slot]
            # The same request on both sides: the pages its step paged out;
            # a request started in between: all its pages (its prefill's).
            new = (before[:, slot] == 0) & (a != 0) if was.get(slot) is r else a != 0
            for lvl in np.unique(a[new]):
                total += counts.quant_bytes(m, pt, int((a[new] == lvl).sum()), bits[int(lvl)])
    return 100.0 * total / peaks.HBM_BYTES_PER_S / secs if total else None
