"""What the kernel rooflines share: the least time of a kernel family's work
in the traced slice over the device time of its kernels, in %.

The least time of one launch is the larger of its operations over the
dtype's peak and its bytes over the HBM's (``peaks.least_seconds``), each
input byte read once and each output byte written once.  ``family`` is the
key of ``entry.work``; ``names`` are the substrings of the family's kernel
names in the profiler's trace; ``count(shape, dtype)`` gives (operations,
bytes) of one launch."""
from portbench.peaks import least_seconds


def share(run, family: str, names, count):
    tr = run.trace
    if tr is None or not tr.window.completed:
        return None
    device = tr.device_seconds(names)
    if device <= 0:
        return None
    least = 0.0
    for req in tr.window.reqs:
        for shape in run.entry.work(req).get(family, ()):
            least += least_seconds(*count(shape, run.dtype), run.dtype)
    return least / device * 100.0 if least > 0 else None
