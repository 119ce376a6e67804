"""The whole request's share of the card's peak in the traced slice: the
algorithm's operations of its requests (``counts.py``) over the slice's host
length, against the data-sheet peak of the operand dtype (``peaks.py``), in
%.  It bounds every kernel's gain: a kernel taken off the path leaves its
roofline silent, not this."""
from portbench.peaks import PEAK_FLOPS


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or not tr.window.completed:
        return None
    flops = sum(run.entry.flops(r) for r in tr.window.reqs)
    return flops / tr.window.seconds / PEAK_FLOPS[run.dtype] * 100.0
