"""The share of the traced slice in which no operation ran on the device:
1 less the union of the profiler's device intervals over the slice's host
length, in %."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return (1.0 - tr.busy_s / tr.window.seconds) * 100.0
