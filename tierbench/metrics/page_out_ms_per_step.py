"""Cache + daemon: host milliseconds a window step spends paging full recent
windows out into the warm tier (the ``recent_len`` copy, kernel #2 and the
roll; ``engine.page_out`` spans)."""

from tierbench import program_spans


def read(res):
    return program_spans.per_step_ms(res, ("engine.page_out",))
