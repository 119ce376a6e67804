"""The port's span-and-counter recorder (``repro_torch.telemetry``) on the
CPU: off it records nothing; on, spans nest with their parents and request
ids, self times add up, the cap drops and counts; the compiler's memo and
pass spans, the span tree of each entry's plain path, and the clock the
profiler's trace shares."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch import telemetry
from repro_torch.compile import compile_gemm
from repro_torch.compile.driver import clear_memo
from repro_torch.kernels import ops
from repro_torch.kernels.gru import FusedGRU, gru_cell

ROOT = Path(__file__).resolve().parent.parent
PASSES = ["compile.map", "compile.select", "compile.schedule",
          "compile.verify", "compile.lower"]


def tree(rec):
    """Each span as (name, parent's name or None), in the order opened."""
    spans = rec.spans()
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None)
            for s in spans]


def test_off_records_nothing():
    assert telemetry.span("a") is telemetry.span("b")
    with telemetry.recording() as rec:
        with telemetry.span("inside"):
            pass
    a, b = torch.randn(8, 4), torch.randn(4, 6)
    ops.scheduled_gemm(a, b)
    with telemetry.span("after"):
        pass
    assert [s.name for s in rec.spans()] == ["inside"]
    assert rec.dropped == 0
    # the off site hands out one shared object and keeps no state
    off = telemetry.span("x")
    with off as got:
        assert got is None
    assert not hasattr(off, "__dict__")


def test_nesting_parents_and_request_ids():
    with telemetry.recording() as rec:
        with telemetry.span("root"):
            with telemetry.span("a"):
                with telemetry.span("a.1"):
                    pass
            with telemetry.span("b"):
                pass
        with telemetry.span("second"):
            with telemetry.span("c"):
                pass
    spans = rec.spans()
    assert [(s.name, s.parent, s.request) for s in spans] == [
        ("root", -1, 0), ("a", 0, 0), ("a.1", 1, 0), ("b", 0, 0),
        ("second", -1, 1), ("c", 4, 1)]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert rec.requests == 2


def test_a_new_recording_clears_the_record():
    with telemetry.recording():
        with telemetry.span("first"):
            pass
    with telemetry.recording() as rec:
        with telemetry.span("second"):
            pass
    assert [(s.name, s.request) for s in rec.spans()] == [("second", 0)]


def test_a_span_that_raises_closes():
    with telemetry.recording() as rec:
        with pytest.raises(ValueError):
            with telemetry.span("outer"):
                with telemetry.span("inner"):
                    raise ValueError("x")
        with telemetry.span("next"):
            pass
    assert [(s.name, s.parent) for s in rec.spans()] == [
        ("outer", -1), ("inner", 0), ("next", -1)]
    assert all(s.end_ns > 0 for s in rec.spans())


def test_self_time_is_the_duration_less_the_childrens():
    with telemetry.recording() as rec:
        with telemetry.span("root"):
            time.sleep(0.002)
            with telemetry.span("a"):
                time.sleep(0.002)
                with telemetry.span("a.1"):
                    time.sleep(0.001)
            with telemetry.span("b"):
                time.sleep(0.001)
    spans, own = rec.spans(), rec.self_ns()
    dur = [s.end_ns - s.start_ns for s in spans]
    for i in range(len(spans)):
        children = sum(dur[j] for j, s in enumerate(spans) if s.parent == i)
        assert own[i] == dur[i] - children
    assert own[0] >= 2_000_000 and own[1] >= 2_000_000
    assert sum(own) == dur[0]


def test_the_cap_drops_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(telemetry, "CAP", 3)
    with telemetry.recording() as rec:
        for _ in range(2):
            with telemetry.span("kept"):
                pass
        with telemetry.span("third"):
            with telemetry.span("dropped"):
                with telemetry.span("dropped too"):
                    pass
        with telemetry.span("dropped three"):
            pass
    assert [s.name for s in rec.spans()] == ["kept", "kept", "third"]
    assert rec.dropped == 3
    assert all(s.end_ns > 0 for s in rec.spans())


def test_memo_hit_and_fresh_counters():
    clear_memo()
    before = telemetry.counters()
    ops.plan_gemm(96, 40, 72)
    ops.plan_gemm(96, 40, 72)
    after = telemetry.counters()
    assert after["compile.memo_hit"] - before["compile.memo_hit"] == 1
    assert after["compile.memo_sig"] - before["compile.memo_sig"] == 1
    assert after["compile.fresh"] - before["compile.fresh"] == 1


def test_counters_are_one_store_that_holds_every_name(monkeypatch):
    monkeypatch.setattr(telemetry, "_counts", dict(telemetry._counts))
    before = telemetry.counters()
    assert set(before) - {"graph.capture", "graph.replay"} == {
        "compile.memo_hit", "compile.memo_sig", "compile.fresh",
        "graph.nodes", "graph.gemm_nodes", "graph.k2_nodes",
        "graph.stream_nodes", "gemm.launches",
        "gemm_bias_act.launches", "gemm_transpose", "gemm_reduce",
        "gru_cell.launches", "gru_cell_reduce", "gru_seq.launches",
        "gru_seq.mma", "conv.gemm"}
    assert set(telemetry.LAUNCH_COUNTERS) <= set(before)
    assert all(v >= 0 for v in before.values())
    telemetry.count("gemm.launches", 3)
    after = telemetry.counters()
    assert {n: after[n] - before[n] for n in before if after[n] != before[n]} \
        == {"gemm.launches": 3}


def test_importing_telemetry_loads_no_other_layer():
    code = ("import json, sys, repro_torch.telemetry; "
            "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.telemetry" in loaded
    assert not [m for m in loaded if m.split(".")[:2] in (
        ["repro_torch", "kernels"], ["repro_torch", "graph"],
        ["repro_torch", "compile"])]


def test_a_replay_advances_the_counters_its_capture_moved(monkeypatch):
    from repro_torch.graph.execute import _advance
    monkeypatch.setattr(telemetry, "_counts", dict(telemetry._counts))
    before = telemetry.counters()
    _advance({"gemm.launches": 4, "graph.nodes": 9})
    after = telemetry.counters()
    assert {n: v - before.get(n, 0) for n, v in after.items()
            if v != before.get(n, 0)} == {"gemm.launches": 4,
                                          "graph.nodes": 9}


def test_a_fresh_compile_spans_its_passes_in_order():
    clear_memo()
    with telemetry.recording() as rec:
        compile_gemm(80, 24, 56, approach="greedy")
    spans = rec.spans()
    assert spans[0].name == "compile.gemm" and spans[0].parent == -1
    assert [s.name for s in spans if s.name in PASSES] == PASSES
    assert all(spans[s.parent].name == "compile.gemm"
               for s in spans if s.name in PASSES)


def test_the_span_tree_of_each_entrys_plain_path():
    a, b = torch.randn(48, 32), torch.randn(32, 16)
    ops.scheduled_gemm(a, b)                       # the memo warm
    with telemetry.recording() as rec:
        ops.scheduled_gemm(a, b)
    assert tree(rec) == [
        ("ops.gemm", None), ("ops.plan", "ops.gemm"),
        ("plan.tuned", "ops.plan"), ("compile.gemm", "ops.plan"),
        ("compile.memo", "compile.gemm"), ("compile.memo", "compile.gemm"),
        ("plan.launch", "ops.plan"),
        ("k1", "ops.gemm"), ("k1.check", "k1")]
    model = FusedGRU(16, 16, device="cpu")
    xs, h0 = torch.randn(3, 2, 16), torch.randn(2, 16)
    ops.scheduled_gru(xs, h0, model)
    with telemetry.recording() as rec:
        ops.scheduled_gru(xs, h0, model)
        gru_cell(xs[0], h0, model.params())
    names = tree(rec)
    assert names[:2] == [("ops.gru", None), ("ops.plan", "ops.gru")]
    assert ("compile.gru", "ops.plan") in names
    assert names[-3:] == [("k4", "ops.gru"), ("k3", None), ("k3.check", "k3")]
    assert {s.request for s in rec.spans()} == {0, 1}


def test_span_times_sit_on_the_profilers_timeline():
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(256, 256)
    with telemetry.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with telemetry.span("mm"):
                x @ x
    start = prof.profiler.kineto_results.trace_start_ns()
    (s,) = rec.spans()
    lo = telemetry.to_profiler_us(s.start_ns, start)
    hi = telemetry.to_profiler_us(s.end_ns, start)
    mm = [ev.time_range for ev in prof.events() if ev.name == "aten::mm"]
    assert len(mm) == 1
    assert lo <= mm[0].start <= mm[0].end <= hi


class _Event:
    """The accessors of a Kineto event that ``device_offset_bounds_ns``
    reads."""

    def __init__(self, name, device, start, end, corr):
        self._v = (name, device, start, end, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return 0


def test_device_offset_bounds_come_from_launches_and_synchronizes():
    from torch.autograd import DeviceType
    host, dev, off = DeviceType.CPU, DeviceType.CUDA, 3000
    events = [
        _Event("cudaLaunchKernel", host, 0, 10, 1),
        _Event("k", dev, 20 + off, 40 + off, 1),
        _Event("cudaDeviceSynchronize", host, 12, 45, 9),
        _Event("cudaLaunchKernel", host, 100, 110, 2),
        _Event("k", dev, 125 + off, 150 + off, 2),
        _Event("cudaDeviceSynchronize", host, 112, 160, 10),
        _Event("k", dev, 0, 1, 77)]                # launched outside the trace
    # at most the least launch-to-start gap (20), at least the largest
    # overrun of a synchronize's end (40 - 45 = -5)
    assert telemetry.device_offset_bounds_ns(events) == (off - 5, off + 20)
    assert telemetry.device_offset_bounds_ns(events[:2]) is None
