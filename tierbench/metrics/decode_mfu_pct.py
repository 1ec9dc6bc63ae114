"""Decode step: the whole step's least time on the card (its FLOPs over
all batch rows, its weight bytes and the cache it read: each active slot's
device pages with scales and its recent rows, from the placement before the
step) as a share of the host time the steps took (``EngineStats.decode_s``),
over the window."""

from tierbench.harness import decode_least_s, stat_delta


def read(res):
    took = stat_delta(res, "decode_s")
    first, last = res.window_steps
    if last <= first or took <= 0:
        return None
    drv = res.drv
    least = 0.0
    for k in range(first, last):
        slots, totals, _ = drv.step_slots[k - drv.base]
        least += decode_least_s(res, k, slots, totals)
    return 100.0 * least / took
