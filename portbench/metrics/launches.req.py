"""Device launches per request in the span slice, from the differences of
the wrappers' launch counters (``telemetry.counters()``): K1/K2's main
loops, transposing passes and split-K reduces, K3's steps and reduces, K4's
recurrences (``spans.py``)."""
from portbench.metrics.spans import LAUNCH_COUNTERS, measure


def read(run):
    sl = measure(run)
    if sl is None:
        return None
    return sum(sl.counts[k] for k in LAUNCH_COUNTERS) / sl.requests
