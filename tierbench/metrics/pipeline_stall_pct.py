"""Media pipeline: share of the window's busy pipeline ticks (demand work
queued) in which no phase progressed, waiting for ring credits or a fault's
backoff (counters ``pipeline.stall_ticks`` over ``pipeline.busy_ticks``)."""

from tierbench import program_spans


def read(res):
    busy = program_spans.counter(res, "pipeline.busy_ticks")
    if not busy:
        return None
    return 100.0 * program_spans.counter(res, "pipeline.stall_ticks") / busy
