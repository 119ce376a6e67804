"""``plan_us`` read inside the program: the host time inside the ``ops.plan``
spans (``plan_gemm``, ``plan_gru``) of the span slice, per request, in us
(``spans.py``)."""
from portbench.metrics.spans import measure


def read(run):
    sl = measure(run)
    return None if sl is None else sl.plan_ns / sl.requests / 1e3
