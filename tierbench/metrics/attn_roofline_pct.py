"""Kernels: the fused tiered decode attention (kernel #1) against its byte
bound. Bytes: ``counts.attention_step_bytes`` of every traced step, from the
pages each active slot held per tier before the step and its live recent
rows (``harness.recent_rows``); time: the kernel's device time in the
traced slice."""

from tierbench import counts, families, peaks, trace
from tierbench.harness import COLD, HOST4, HOST8, WARM, recent_rows


def read(res):
    tr = res.trace
    if tr is None:
        return None
    secs, launches = tr.kernel_seconds(trace.ATTENTION)
    if launches == 0 or secs <= 0:
        return None
    conf = res.cell.conf
    m = families.of(conf).shape(conf)
    t = conf["tiering"]
    pt = int(t["page_tokens"])
    drv = res.drv
    total = 0
    for k in range(*res.slice_steps):
        slots, totals, _ = drv.step_slots[k - drv.base]
        lv = drv.levels_at(k)[:, slots]
        total += counts.attention_step_bytes(
            m, pt, int(t["warm_bits"]), int(t["cold_bits"]), (lv == WARM).sum(-1),
            (lv == COLD).sum(-1), ((lv == HOST8) | (lv == HOST4)).sum(-1),
            recent_rows(lv, totals, pt))
    return 100.0 * total / peaks.HBM_BYTES_PER_S / secs
