"""Media pipeline: host milliseconds a tier-window boundary spends turning
the plan into cohorts, claiming or discarding prefetched pages and
submitting them (``cache.submit`` spans, over the window's boundaries)."""

from tierbench import program_spans


def read(res):
    return program_spans.per_boundary_ms(res, "cache.submit")
