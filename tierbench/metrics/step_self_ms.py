"""Engine: host milliseconds a window step spends in ``TieredEngine.step``
outside its child spans (token bookkeeping, the boundary's TCO snapshot):
the ``engine.step`` spans less their children, over the window's steps."""

from tierbench import program_spans


def read(res):
    return program_spans.step_self_ms(res)
