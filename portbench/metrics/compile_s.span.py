"""``compile_s`` read inside the program: the summed length of the
``compile.gemm`` / ``compile.gru`` root spans of one fresh compile of the
cell's program set (memo cleared), after the span slice, in s
(``spans.py``)."""
from portbench.metrics.spans import measure


def read(run):
    sl = measure(run)
    return None if sl is None else sl.compile_ns / 1e9
