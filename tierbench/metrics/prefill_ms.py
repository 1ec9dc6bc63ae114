"""Engine: host milliseconds a prefill takes (the model's prefill, the
prompt's page-out, the first token's argmax copy), over the window's
prefills (``EngineStats.prefill_s``)."""

from tierbench.harness import stat_delta


def read(res):
    n = len(res.prefills)
    return stat_delta(res, "prefill_s") / n * 1e3 if n else None
