"""Model: the prefills' least time on the card (``peaks.least_time_s`` of
each prefill's FLOPs and weight bytes, ``counts.prefill``) as a share of
the host time they took (``EngineStats.prefill_s``), over the window."""

from tierbench import counts, peaks
from tierbench.harness import stat_delta


def read(res):
    took = stat_delta(res, "prefill_s")
    if not res.prefills or took <= 0:
        return None
    m = counts.dims(res.cell.conf)
    least = sum(peaks.least_time_s(*counts.prefill(m, s)) for s in res.prefills)
    return 100.0 * least / took
