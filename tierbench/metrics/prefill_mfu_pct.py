"""Model: the prefills' least time on the card (``peaks.least_time_s`` of
each prefill's FLOPs and bytes, the family module's ``prefill``) as a share of
the host time they took (``EngineStats.prefill_s``), over the window."""

from tierbench import families, peaks
from tierbench.harness import stat_delta


def read(res):
    took = stat_delta(res, "prefill_s")
    if not res.prefills or took <= 0:
        return None
    conf = res.cell.conf
    fam = families.of(conf)
    least = sum(peaks.least_time_s(*fam.prefill(conf, s)) for s in res.prefills)
    return 100.0 * least / took
