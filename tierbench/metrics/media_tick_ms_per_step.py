"""Media pipeline: host milliseconds a window step spends in the step's
migration-pipeline tick or speculative prefetch tick (``pipeline.tick`` and
``cache.prefetch_tick`` spans opened by the step)."""

from tierbench import program_spans


def read(res):
    return program_spans.per_step_ms(res, ("pipeline.tick", "cache.prefetch_tick"))
