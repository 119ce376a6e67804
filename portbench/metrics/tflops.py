"""The algorithm's operations of every request completed in the window
(``counts.py``, from the shapes) over the window's length, in TFLOP/s."""


def read(run):
    w = run.window
    if not w.completed:
        return None
    return sum(run.entry.flops(r) for r in w.reqs) / w.seconds / 1e12
