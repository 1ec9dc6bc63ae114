"""Cache + daemon: host milliseconds a tier-window boundary spends in the
placement policy (adaptive media, the fault window, ``manager.end_window``;
``cache.policy`` spans, over the window's boundaries)."""

from tierbench import program_spans


def read(res):
    return program_spans.per_boundary_ms(res, "cache.policy")
