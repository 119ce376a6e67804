"""The share of the span slice in which no operation ran on the device and
the host was in no span of the program, in % (``spans.py``): the caller's
synchronize and its loop."""
from portbench.metrics.spans import measure


def read(run):
    sl = measure(run)
    return None if sl is None or sl.idle is None else sl.idle["outside"]
