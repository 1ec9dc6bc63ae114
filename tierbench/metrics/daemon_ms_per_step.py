"""Cache + daemon: host milliseconds a step spends outside the decode step
and the boundaries: the telemetry fold, the media pipeline's tick or the
prefetch tick (``EngineStats.daemon_s - window_s``, over the steps)."""

from tierbench.harness import stat_delta


def read(res):
    n = stat_delta(res, "steps")
    if not n:
        return None
    return (stat_delta(res, "daemon_s") - stat_delta(res, "window_s")) / n * 1e3
