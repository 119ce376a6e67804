"""The host time of a request in the graph executor's interpreter: inside
the ``graph.stream`` (interpreted nodes) and ``graph.epilogue`` (the
statements after a K1 or K2 launch) spans of the span slice, per request,
in us (``spans.py``).  Nothing where the program records no
``graph.execute`` span."""
from portbench.metrics.spans import measure

SPANS = ("graph.stream", "graph.epilogue")


def read(run):
    sl = measure(run)
    if sl is None or "graph.execute" not in sl.by_name:
        return None
    return sum(sl.by_name.get(n, (0, 0, 0))[1] for n in SPANS) \
        / sl.requests / 1e3
