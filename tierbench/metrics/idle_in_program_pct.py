"""Device: share of the traced slice's device-idle time during which a
program span other than ``engine.step`` was the innermost open one (the
program's spans placed on the trace's clock, ``program_spans``)."""

from tierbench import program_spans


def read(res):
    return program_spans.idle_in_program_pct(res)
