"""Media pipeline: share of the window's decode steps retired while a
migration cohort was in flight (``EngineStats.overlapped_steps``)."""

from tierbench.harness import stat_delta


def read(res):
    n = stat_delta(res, "steps")
    return 100.0 * stat_delta(res, "overlapped_steps") / n if n else None
