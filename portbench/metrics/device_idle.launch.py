"""The share of the span slice in which no operation ran on the device and
the host was inside a request root but in no ``ops.plan`` span, in %
(``spans.py``): the checks, allocations, packing and C calls."""
from portbench.metrics.spans import measure


def read(run):
    sl = measure(run)
    return None if sl is None or sl.idle is None else sl.idle["launch"]
