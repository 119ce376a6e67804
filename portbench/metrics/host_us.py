"""A request's host time in the traced slice: its latency less the device
time of its operations (the profiler's), averaged over the slice's
requests, in us."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or not tr.window.completed:
        return None
    device = sum(e - s for _, s, e in tr.ops) / 1e6
    return (sum(tr.window.latencies) - device) / tr.window.completed * 1e6
