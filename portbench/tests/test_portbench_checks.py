"""``correct`` on the CPU at small sizes: true for the program's sound path,
false for the control and for each fault a cell can have, planted under
the timed path.  The program's CPU path is its plain versions; the limits
are the committed ones."""
from __future__ import annotations

import pytest
import torch
from _cells import CELLS, SMALL, run_small

from portbench import harness

from repro_torch.kernels import gru, ops


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run_small(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = run_small(name, control=True)
    assert not out["correct"], out["checks"]


def _half_rows_left_out(t):
    t = t.clone()
    t[t.shape[0] // 2:] = 0
    return t


def _one_row_altered(t):
    t = t.clone()
    t[0] = -t[0]
    return t


GEMM_FAULTS = {"half_left_out": _half_rows_left_out,
               "answer_altered": _one_row_altered}


@pytest.mark.parametrize("fault", sorted(GEMM_FAULTS))
@pytest.mark.parametrize("name", ["gemm-f32-pass", "gemm-bf16-call"])
def test_gemm_fault_is_not_correct(name, fault, monkeypatch):
    sound = ops.scheduled_gemm

    def broken(a, b, graph=None):
        c, cfg = sound(a, b, graph)
        return GEMM_FAULTS[fault](c), cfg
    monkeypatch.setattr(ops, "scheduled_gemm", broken)
    assert not run_small(name)["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_gru_seq_fault_is_not_correct(fault, monkeypatch):
    sound = ops.scheduled_gru

    def broken(xs, h0, model, graph=None):
        if fault == "state_unchanged":
            return h0.clone()
        h = sound(xs, h0, model, graph)
        return GEMM_FAULTS[fault](h)
    monkeypatch.setattr(ops, "scheduled_gru", broken)
    assert not run_small("gru-seq-bf16")["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_gru_stream_fault_is_not_correct(fault, monkeypatch):
    sound = gru.gru_cell

    def broken(x, h, params, tile=gru.DEFAULT_TILE, out=None):
        if fault == "state_unchanged":
            return h.clone()
        return GEMM_FAULTS[fault](sound(x, h, params, tile, out))
    monkeypatch.setattr(gru, "gru_cell", broken)
    assert not run_small("gru-stream-bf16")["correct"]


def test_a_failing_request_is_not_correct(monkeypatch):
    sound = ops.scheduled_gemm
    calls = []

    def fails_after_warm_up(a, b, graph=None):
        calls.append(1)
        if len(calls) > harness.WARM_ROUNDS * len(SMALL["deepbench-gemm"]["shapes"]):
            raise RuntimeError("launch failed")
        return sound(a, b, graph)
    monkeypatch.setattr(ops, "scheduled_gemm", fails_after_warm_up)
    out = run_small("gemm-bf16-call")
    assert not out["correct"] and out["failed"] == out["attempted"] > 0
    assert out["errors"] == ["RuntimeError: launch failed"] * 3


def test_traced_run_reads_per_layer_metrics_on_the_cpu():
    out = run_small("gemm-f32-pass", trace=True)
    # no device operations on the CPU: only the host-clock readers report
    assert set(out["metrics"]) == {"compile_s", "plan_us", "tflops.p95"}
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    assert torch.get_default_dtype() == torch.float32
