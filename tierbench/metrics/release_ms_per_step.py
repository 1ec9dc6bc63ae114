"""Cache + daemon: host milliseconds a window step spends freeing finished
requests' pages, a pipeline drain included where their pages ride a queued
cohort (``engine.release`` spans)."""

from tierbench import program_spans


def read(res):
    return program_spans.per_step_ms(res, ("engine.release",))
