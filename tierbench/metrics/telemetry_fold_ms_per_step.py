"""Cache + daemon: host milliseconds a window step spends folding the
decode step's hotness telemetry into the placement counts, with the page
tables' copies off the device (``cache.fold_telemetry`` spans)."""

from tierbench import program_spans


def read(res):
    return program_spans.per_step_ms(res, ("cache.fold_telemetry",))
