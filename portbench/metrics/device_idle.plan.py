"""The share of the span slice in which no operation ran on the device and
the host was inside an ``ops.plan`` span, in % (``spans.py``).  The three
``device_idle.*`` shares add up to the slice's idle share."""
from portbench.metrics.spans import measure


def read(run):
    sl = measure(run)
    return None if sl is None or sl.idle is None else sl.idle["plan"]
