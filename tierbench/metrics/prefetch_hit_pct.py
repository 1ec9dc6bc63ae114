"""Media pipeline: share of the prefetched pages that met a tier-window
boundary in the window and were claimed by its plan (counters
``prefetch.hits`` over hits plus ``prefetch.misses``); None where no staged
page met a boundary."""

from tierbench import program_spans


def read(res):
    hits = program_spans.counter(res, "prefetch.hits")
    if hits is None:
        return None
    met = hits + program_spans.counter(res, "prefetch.misses")
    return 100.0 * hits / met if met else None
