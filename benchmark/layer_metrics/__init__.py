"""Per-layer metrics, one reader a metric (``layer_metrics/<metric>.py``,
found by the metric's name in ``BENCHMARK.json``). Each has
``read(run) -> float | None``: ``run`` is the finished traced run
(``harness.Run``); a reader that finds nothing to read returns None and
the metric is left out of the result line."""
