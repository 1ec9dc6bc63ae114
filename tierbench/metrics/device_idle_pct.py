"""Device: share of the traced slice in which no kernel, copy or memset ran
on the card (the union of the profiler's device intervals)."""


def read(res):
    tr = res.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
