"""Cache + daemon: host milliseconds of a tier-window boundary (drain of a
previous window's stragglers, the placement plan, the cohorts' submission),
over the window's boundaries (``EngineStats.window_s``)."""

from tierbench.harness import stat_delta


def read(res):
    n = stat_delta(res, "windows")
    return stat_delta(res, "window_s") / n * 1e3 if n else None
