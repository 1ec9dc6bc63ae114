"""Decode step: host milliseconds a window step blocks on the step's device
work, the telemetry and argmax copies to the host (``engine.decode.wait``
spans, over the window's steps)."""

from tierbench import program_spans


def read(res):
    return program_spans.per_step_ms(res, ("engine.decode.wait",), parent="engine.decode")
