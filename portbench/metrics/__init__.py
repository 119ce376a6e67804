"""One reader a metric, found by the metric's name in ``BENCHMARK.json``:
``read(run)`` takes the number from ``harness.Run`` (the window, the traced
slice, the entry) and returns it, or ``None`` where there is nothing to
read, and the metric is then left out of the result line."""
