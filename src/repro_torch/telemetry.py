"""The port's spans and counters: where the host's time goes inside the
program, on the clock of the torch profiler's device trace.

A span site is ``with span("k1.call"): ...``.  The recorder is off by
default: a site then costs one check of a module-level flag and returns a
shared no-op context manager, allocating and recording nothing.  Inside
``recording()`` a span records its name, start and end
(``time.perf_counter_ns``), its parent span and its request.  A span opened
with no span open is a root and opens a new request id; the spans below it
share that id.  Spans are kept in flat ``array``s, which the garbage
collector does not walk, up to a cap; spans past the cap are dropped and
counted.  One thread records: spans nest as the ``with`` statements do.

Counters are plain integers in one store, counted whether recording or
not: ``count(name)`` adds one (``count(name, n)`` adds n; a name first
counted appears then).  The kernel wrappers count their launches here
(``LAUNCH_COUNTERS``), the compiler its memo and the graph executor its
nodes.  A reader takes differences of two ``counters()``.

``to_profiler_us`` puts a span's time on the profiler's host timeline (the
microseconds of ``FunctionEvent.time_range``, counted from the trace's
start) through the anchor pair (``perf_counter_ns``, ``time_ns``) taken as
recording starts: Kineto's timestamps are epoch nanoseconds.  Its device
timestamps are not always on that timeline: on an H100 a trace's kernels
have sat up to milliseconds off the host calls that launched them, and the
next trace not.  ``device_offset_bounds_ns`` bounds that offset from the
trace itself.
"""
from __future__ import annotations

import time
from array import array
from bisect import bisect_left
from contextlib import contextmanager
from typing import NamedTuple

#: spans one recording keeps; later ones are dropped and counted
CAP = 1 << 20

#: the kernel wrappers' launch counters: K1, K2 (``projection`` counts as
#: K2), K3 and its split step's reduce, K4, then the passes inside K1's and
#: K2's launch (the wgmma route's transpose of B, split-K's reduce)
LAUNCH_COUNTERS = ("gemm.launches", "gemm_bias_act.launches",
                   "gru_cell.launches", "gru_cell_reduce", "gru_seq.launches",
                   "gemm_transpose", "gemm_reduce")
#: every counter, by name; these read 0 from import.  ``gru_seq.mma``
#: counts K4's launches that ran the tensor-core inner product (bf16), a
#: share of ``gru_seq.launches``, not a launch of its own; ``conv.gemm``
#: counts the convolutions ``ops.scheduled_conv`` ran as one K1 GEMM, each
#: beside its ``gemm.launches``
_counts = dict.fromkeys(("compile.memo_hit", "compile.memo_sig",
                         "compile.fresh", "graph.nodes", "graph.gemm_nodes",
                         "graph.k2_nodes", "graph.stream_nodes",
                         "gru_seq.mma", "conv.gemm") + LAUNCH_COUNTERS, 0)


class Span(NamedTuple):
    """One recorded span; times are ``perf_counter_ns``."""

    name: str
    start_ns: int
    end_ns: int
    parent: int      # index of the enclosing span in the record, -1: a root
    request: int


class Record:
    """The spans of one ``recording()``."""

    def __init__(self, cap: int):
        self.cap = cap
        self.names: list[str] = []
        self._ids: dict[str, int] = {}
        self.name_id = array("i")
        self.start = array("q")
        self.end = array("q")
        self.parent = array("i")
        self.request = array("i")
        self.open_spans: list[int] = []
        self.requests = 0
        self.dropped = 0
        #: one instant on both clocks: (perf_counter_ns, time_ns)
        self.anchor = (time.perf_counter_ns(), time.time_ns())

    def _open(self, name: str):
        n = len(self.start)
        if n >= self.cap:
            self.dropped += 1
            return _OFF
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self.names)
            self.names.append(name)
        if self.open_spans:
            top = self.open_spans[-1]
            self.parent.append(top)
            self.request.append(self.request[top])
        else:
            self.parent.append(-1)
            self.request.append(self.requests)
            self.requests += 1
        self.name_id.append(i)
        self.end.append(0)
        self.open_spans.append(n)
        self.start.append(time.perf_counter_ns())
        return _CLOSE

    def _close(self) -> None:
        t = time.perf_counter_ns()
        if self.open_spans:
            self.end[self.open_spans.pop()] = t

    def _finish(self) -> None:
        """Close what is still open at the end of the recording."""
        while self.open_spans:
            self._close()

    def spans(self) -> list[Span]:
        return [Span(self.names[i], s, e, p, r) for i, s, e, p, r in
                zip(self.name_id, self.start, self.end, self.parent,
                    self.request)]

    def self_ns(self) -> list[int]:
        """Each span's self time: its duration less its children's."""
        out = [e - s for s, e in zip(self.start, self.end)]
        for p, s, e in zip(self.parent, self.start, self.end):
            if p >= 0:
                out[p] -= e - s
        return out


class _Off:
    """The no-op span: what a site gets while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


class _Close:
    """What a recorded span returns: its exit closes the innermost open
    span, which is itself since spans nest."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        _record._close()
        return None


_OFF = _Off()
_CLOSE = _Close()
_on = False
_record = Record(cap=0)


def span(name: str):
    """A context manager that records ``name`` around its body while
    recording, and does nothing otherwise."""
    if not _on:
        return _OFF
    return _record._open(name)


@contextmanager
def recording():
    """Turn the recorder on for the body, on a cleared record (which it
    yields and which stays readable afterwards); off again on exit."""
    global _on, _record
    _record = Record(CAP)
    _on = True
    try:
        yield _record
    finally:
        _on = False
        _record._finish()


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """Every counter as it reads now."""
    return dict(_counts)


def to_profiler_us(t_ns: int, trace_start_ns: int) -> float:
    """A ``perf_counter_ns`` time of the last recording on the profiler's
    timeline: microseconds after ``trace_start_ns``
    (``prof.profiler.kineto_results.trace_start_ns()``)."""
    perf, epoch = _record.anchor
    return (t_ns - perf + epoch - trace_start_ns) / 1e3


def device_offset_bounds_ns(events) -> tuple[int, int] | None:
    """Bounds (lo, hi) on how far a trace's device timestamps lie after its
    host ones, in ns, from ``prof.profiler.kineto_results.events()``: each
    device operation starts after the host call that launched it began
    (paired by correlation id), so the offset is at most the least such
    gap, and ends before the first ``cudaDeviceSynchronize`` that began
    after that call, so it is at least the largest overrun.  ``None``
    without a launch followed by a synchronize; lo <= hi on a consistent
    trace, and device times less an offset between them are host times."""
    from torch.autograd import DeviceType
    device, host, syncs = [], {}, []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            device.append(e)
        elif e.name() == "cudaDeviceSynchronize":
            syncs.append((e.start_ns(), e.end_ns()))
        elif e.correlation_id():
            host[e.correlation_id()] = e
    syncs.sort()
    starts = [s for s, _ in syncs]
    lo = hi = None
    for d in device:
        call = (host.get(d.correlation_id())
                or host.get(d.linked_correlation_id()))
        if call is None:
            continue
        i = bisect_left(starts, call.end_ns())
        if i == len(syncs):
            continue
        gap = d.start_ns() - call.start_ns()
        over = d.end_ns() - syncs[i][1]
        hi = gap if hi is None else min(hi, gap)
        lo = over if lo is None else max(lo, over)
    return None if hi is None else (lo, hi)
