"""The span readers (``metrics/spans.py`` and the metrics that read it) on
the CPU: which cells report which, what reports without a card, the idle
split's arithmetic, and that a program without the recorder gives
nothing."""
from __future__ import annotations

import builtins

import pytest
from _cells import run_small

from portbench import harness
from portbench.metrics import spans

HOST = {"plan_us.span", "launch_us.span", "memo_hit.plan", "launches.req",
        "compile_s.span"}
IDLE = {"device_idle.plan", "device_idle.launch", "device_idle.outside"}
PLANNING = ("gemm-f32-pass", "gru-seq-bf16", "gemm-bf16-call")


def test_cells_of_the_span_metrics():
    bench = harness.load_benchmark()
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-8:] == ["plan_us.span", "launch_us.span", "memo_hit.plan",
                          "launches.req", "device_idle.plan",
                          "device_idle.launch", "device_idle.outside",
                          "compile_s.span"]
    for cell in PLANNING + ("gru-stream-bf16",):
        got = {m["name"] for m in harness.cell_metrics(bench, cell,
                                                       "per_layer")}
        want = HOST | IDLE
        if cell not in PLANNING:
            want = want - {"plan_us.span", "memo_hit.plan",
                           "device_idle.plan"}
        assert got & (HOST | IDLE) == want, cell


@pytest.mark.parametrize("name", ["gemm-f32-pass", "gru-stream-bf16"])
def test_host_readers_report_and_idle_readers_do_not_on_the_cpu(name):
    out = run_small(name, trace=True)
    assert out["correct"], out["checks"]
    got = set(out["metrics"])
    want = HOST if name == "gemm-f32-pass" else \
        HOST - {"plan_us.span", "memo_hit.plan"}
    assert got & (HOST | IDLE) == want
    m = out["metrics"]
    if name == "gemm-f32-pass":
        assert m["memo_hit.plan"]["value"] == 100.0
        assert m["plan_us.span"]["value"] > 0
    assert m["launch_us.span"]["value"] > 0
    assert m["launches.req"]["value"] == 0.0       # no launch on the CPU
    assert m["compile_s.span"]["value"] > 0


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    real = builtins.__import__

    def no_recorder(name, *args, **kw):
        if name == "repro_torch" and "telemetry" in (args[2] or ()):
            raise ImportError("no telemetry")
        return real(name, *args, **kw)
    monkeypatch.setattr(builtins, "__import__", no_recorder)
    assert spans.measure(object.__new__(harness.Run)) is None


def test_the_idle_split_partitions_the_slices_idle_time():
    # a slice 0..100 us: the device busy 10..20 and 50..60; requests'
    # roots 5..45 and 55..95, plans 5..15 and 55..70
    ops = [("k", 10.0, 20.0), ("k", 50.0, 60.0), ("k", 200.0, 210.0)]
    got = spans.idle_split(ops, [0.0, 45.0, 50.0, 100.0],
                           [(5.0, 45.0), (55.0, 95.0)],
                           [(5.0, 15.0), (55.0, 70.0)])
    assert got["slice"] == pytest.approx(80.0)
    assert got["plan"] == pytest.approx(5.0 + 10.0)
    assert got["launch"] == pytest.approx(25.0 + 25.0)
    assert got["outside"] == pytest.approx(5.0 + 5.0 + 5.0)
    assert got["plan"] + got["launch"] + got["outside"] == \
        pytest.approx(got["slice"])


def test_merge_and_overlap():
    assert spans.merge([(3, 5), (1, 2), (2, 4), (7, 8)]) == [[1, 5], [7, 8]]
    assert spans.overlap([[0, 10], [20, 30]], [[5, 25]]) == 10
