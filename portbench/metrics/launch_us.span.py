"""The host time of a request inside the program but not in its plans: the
span slice's request roots (``ops.gemm``, ``ops.gru``, and ``k1``-``k4``
called directly) less their ``ops.plan`` spans, per request, in us: the
checks, the allocations, the packing and the C calls (``spans.py``)."""
from portbench.metrics.spans import measure


def read(run):
    sl = measure(run)
    return None if sl is None else \
        (sl.root_ns - sl.plan_ns) / sl.requests / 1e3
