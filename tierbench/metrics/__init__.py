"""Per-layer metric readers, one module a metric, found by the metric's name
in ``BENCHMARK.json``: ``read(result) -> float | None`` (None where the run
holds nothing to read; the metric is then left out of the line)."""
