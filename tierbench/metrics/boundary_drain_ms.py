"""Cache + daemon: host milliseconds a tier-window boundary spends draining
the last window's cohorts and finishing speculative staging
(``cache.drain`` spans, over the window's boundaries)."""

from tierbench import program_spans


def read(res):
    return program_spans.per_boundary_ms(res, "cache.drain")
