"""What the span readers share (not a metric): one slice of the cell's closed
loop with the program's recorder (``repro_torch.telemetry``) and the
profiler both on, then one fresh compile of the cell's program set with the
recorder on.

``measure(run)`` runs once per traced run and is memoised on the run.  The
metrics that call it come last in ``BENCHMARK.json``, so it runs after every
other reader and changes none of their readings.  Its slice is the harness's
own closed loop (``harness.drive``) on ``entry.call`` for
``harness.TRACE_SECONDS``, with every request bracketed on
``perf_counter_ns`` from the call to the end of its synchronize; what the
requests return goes to a sample of its own, so the sample the check judges
is the one the harness kept.  Then ``clear_memo()`` and one
``entry.compile_set()``, which leaves the compiler's memo holding the same
programs it held.  The trace's device times are moved onto its host timeline
by ``telemetry.device_offset_bounds_ns`` before the idle split.

A program without the recorder (``ImportError``), or a record that dropped
spans, gives ``None``, and so does every reader.  Without device operations
(the CPU) the idle shares are ``None`` and the host-clock readings stand.
"""
from __future__ import annotations

import gc
import time
from array import array
from dataclasses import dataclass

import torch

from portbench import harness

#: the launch counters of ``telemetry.counters()``: each a device launch
LAUNCH_COUNTERS = ("gemm.launches", "gemm_bias_act.launches",
                   "gemm_transpose", "gemm_reduce", "gru_cell.launches",
                   "gru_cell_reduce", "gru_seq.launches")
PLAN = "ops.plan"


@dataclass
class Slice:
    """What ``measure`` found; times in ns, shares in % of the slice."""

    requests: int
    root_ns: int                  # host time inside request roots
    plan_ns: int                  # host time inside ``ops.plan`` spans
    counts: dict                  # ``telemetry.counters()`` differences
    idle: dict | None             # plan, launch, outside, and their sum
    device_shift_us: float | None  # the trace's device offset, taken off
    compile_ns: int               # the fresh compile's ``compile.*`` roots
    #: span name -> [count, total ns, self ns], of the slice and of the
    #: fresh compile: the per-span breakdown, which no metric reads
    by_name: dict
    compile_by_name: dict


def measure(run) -> Slice | None:
    if not hasattr(run, "_spans"):
        run._spans = _measure(run)
    return run._spans


def _measure(run) -> Slice | None:
    try:
        from repro_torch import telemetry
        from repro_torch.compile.driver import clear_memo
    except ImportError:                  # a program without the recorder
        return None
    tr = run.trace
    if tr is None or not tr.window.completed:
        return None
    on_card = bool(tr.ops)               # the harness's slice ran on the card
    sync_device = torch.cuda.synchronize if on_card else (lambda: None)
    entry = run.entry
    n_classes = len(entry.classes)
    requests = harness.Requests(n_classes, max(tr.window.slots) + 1, 0)
    sample = harness.Sample(n_classes, 1, 0)
    brackets = array("q")
    clock = time.perf_counter_ns
    start = [0]

    def call(req):
        start[0] = clock()
        return entry.call(req)

    def sync():
        sync_device()
        brackets.append(start[0])
        brackets.append(clock())

    before = telemetry.counters()
    with telemetry.recording() as rec:
        prof = _profiler(on_card)
        with prof:
            harness.drive(call, sync, requests, sample, harness.TRACE_SECONDS)
    after = telemetry.counters()
    spans = rec.spans()
    n = len(brackets) // 2
    if not n or rec.dropped:
        return None
    roots = [(s.start_ns, s.end_ns) for s in spans if s.parent < 0]
    plans = [(s.start_ns, s.end_ns) for s in spans if s.name == PLAN]
    idle = shift = None
    if on_card:
        results = prof.profiler.kineto_results
        start = results.trace_start_ns()
        # the trace's device timeline put on its host one, which the spans
        # share: shifted by the middle of the offset's causal bounds
        bounds = telemetry.device_offset_bounds_ns(results.events())
        shift = 0.0 if bounds is None else (bounds[0] + bounds[1]) / 2e3

        def us(t):
            return telemetry.to_profiler_us(t, start)
        idle = idle_split([(n, s - shift, e - shift)
                           for n, s, e in harness.device_ops(prof)],
                          [us(t) for t in brackets],
                          [(us(s), us(e)) for s, e in roots],
                          [(us(s), us(e)) for s, e in plans])
    del prof
    by_name = _by_name(spans, rec.self_ns())
    clear_memo()
    gc.collect()
    with telemetry.recording() as rec:
        entry.compile_set()
    compiled = rec.spans()
    compile_ns = sum(s.end_ns - s.start_ns for s in compiled
                     if s.parent < 0 and s.name.startswith("compile."))
    return Slice(requests=n, root_ns=sum(e - s for s, e in roots),
                 plan_ns=sum(e - s for s, e in plans),
                 counts={k: after[k] - before.get(k, 0) for k in after},
                 idle=idle, device_shift_us=shift, by_name=by_name,
                 compile_ns=compile_ns,
                 compile_by_name=_by_name(compiled, rec.self_ns()))


def _profiler(on_card: bool):
    if not on_card:
        from contextlib import nullcontext
        return nullcontext()
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def _by_name(spans, self_ns) -> dict:
    out: dict[str, list] = {}
    for s, own in zip(spans, self_ns):
        row = out.setdefault(s.name, [0, 0, 0])
        row[0] += 1
        row[1] += s.end_ns - s.start_ns
        row[2] += own
    return out


def merge(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """The length both of two sorted disjoint interval lists cover."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split(ops, brackets, roots, plans) -> dict | None:
    """The share of the slice (first request's start to last one's end) in
    which no device operation ran, split by what the host was doing: inside
    an ``ops.plan`` span (``plan``), inside a request root but no plan
    (``launch``), in no program span (``outside``); ``slice`` is their sum.
    All times in the profiler's microseconds."""
    lo, hi = brackets[0], brackets[-1]
    length = hi - lo
    if length <= 0:
        return None
    busy = merge((max(s, lo), min(e, hi)) for _, s, e in ops
                 if e > lo and s < hi)
    idle, t = [], lo
    for s, e in busy:
        if s > t:
            idle.append([t, s])
        t = max(t, e)
    if t < hi:
        idle.append([t, hi])
    idle_total = sum(e - s for s, e in idle)
    in_plan = overlap(idle, merge(plans))
    in_root = overlap(idle, merge(list(roots) + list(plans)))
    return {"plan": in_plan / length * 100.0,
            "launch": (in_root - in_plan) / length * 100.0,
            "outside": (idle_total - in_root) / length * 100.0,
            "slice": idle_total / length * 100.0}
