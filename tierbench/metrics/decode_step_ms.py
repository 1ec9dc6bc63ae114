"""Engine: host milliseconds a decode step takes (the captured step and the
telemetry copy to the host), over the window's steps
(``EngineStats.decode_s``)."""

from tierbench.harness import stat_delta


def read(res):
    n = stat_delta(res, "steps")
    return stat_delta(res, "decode_s") / n * 1e3 if n else None
