"""The ``whisper-block-f32`` cell on the CPU, cut to a small size: its
hand-worked operations, ``correct`` true for the sound path and false for
the control and for a fault planted under the timed path, its metrics
(two of its own, six accepted ones whose readers read it too), and its
files' imports."""
from __future__ import annotations

import ast
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.entries.graph_block import gemm_flops, gemms

HERE = Path(harness.__file__).resolve().parent
CELL = "whisper-block-f32"
NEW_METRICS = {"gemm_roofline.graph", "stream_us.span"}
#: the accepted per-layer metrics whose readers read this cell too
SHARED_METRICS = {"compile_s", "mfu.p95", "launches.req", "device_idle.p95",
                  "device_idle.launch", "device_idle.outside"}
#: the configuration cut for the CPU (the card runs it whole)
SMALL = {"d_model": 32, "decoder_attention_heads": 2, "head_dim": 16,
         "decoder_ffn_dim": 64, "vocab_size": 64, "max_source_positions": 12,
         "decoder_layers": 2}


def run_small(control: bool = False, trace: bool = False,
              seed: int = 2**31 + 11) -> dict:
    bench = harness.load_benchmark()
    cell = harness.load_cell(bench, CELL)
    cell.config.update(SMALL)
    cell.traffic = {**cell.traffic, "seq_lens": [8, 5]}
    return harness.run_cell(cell, seed, 0.3, trace, torch.device("cpu"),
                            time.perf_counter(), control=control)


@pytest.mark.parametrize("T,gflop", [(32, 33.13), (128, 57.21),
                                     (224, 81.59), (448, 139.66)])
def test_flops_are_the_layers_equations_by_hand(T, gflop):
    c = harness.load_json("configs", "whisper-medium-block")
    D, F, V = c["d_model"], c["decoder_ffn_dim"], c["vocab_size"]
    S, L = c["max_source_positions"], c["decoder_layers"]
    # a layer: q, k, v, o of self-attention (8 T D^2) and its two products
    # over T keys (4 T^2 D); cross-attention's q, o (4 T D^2), k, v over
    # the frames (4 S D^2) and its products (4 T S D); the MLP (4 T D F)
    layer = (8 * T * D * D + 4 * T * T * D + 4 * T * D * D + 4 * S * D * D
             + 4 * T * S * D + 4 * T * D * F)
    want = L * layer + 2 * T * D * V
    got = sum(gemm_flops(s) for s in gemms(T, S, D, 16, F, V, L))
    assert got == want
    assert got / 1e9 == pytest.approx(gflop, abs=0.005)


def test_sound_run_is_correct():
    out = run_small()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == {"rel_rms", "stream_rel_rms"}
    assert set(out["metrics"]) == {"p95_ms", "setup_s"}


def test_control_is_not_correct():
    assert not run_small(control=True)["correct"]


def test_one_head_left_out_is_not_correct(monkeypatch):
    """The output projection of one head of the second layer's
    self-attention returns zeros, under ``CompiledGraph.execute``."""
    from repro_torch.graph import execute
    sound_step, sound_run = execute.gemm_step, execute.run_gemm_step
    faulty = []

    def step(node, kernel):
        s = sound_step(node, kernel)
        if node.name == "l1.sa.p1":
            faulty.append(s)
        return s

    def run(s, ins):
        out = sound_run(s, ins)
        if any(s is f for f in faulty):
            out = {k: torch.zeros_like(v) for k, v in out.items()}
        return out
    monkeypatch.setattr(execute, "gemm_step", step)
    monkeypatch.setattr(execute, "run_gemm_step", run)
    out = run_small()
    assert faulty and not out["correct"], out["checks"]


def test_traced_run_reads_the_cells_metrics_on_the_cpu():
    out = run_small(trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    # the device-trace readers need the card; the others read on the CPU
    assert set(m) == {"compile_s", "stream_us.span", "launches.req"}
    assert m["stream_us.span"]["value"] > 0
    assert m["launches.req"]["value"] == 0        # no card: no launches


def test_metrics_of_the_new_cell():
    bench = harness.load_benchmark()
    names = {m["name"] for m in
             harness.cell_metrics(bench, CELL, "per_layer")}
    assert names == NEW_METRICS | SHARED_METRICS
    assert {m["name"] for m in
            harness.cell_metrics(bench, CELL, "end_to_end")} == \
        {"p95_ms", "setup_s"}
    for m in bench["per_layer"]:
        if m["name"] in NEW_METRICS:
            assert m["workloads"] == [CELL]
        elif m["name"] in SHARED_METRICS:
            assert m["workloads"][-1] == CELL
        else:
            assert CELL not in m["workloads"]
    cell = harness.find(bench["workloads"], CELL, "workload")
    assert cell["chips"] == 1
    assert harness.find(bench["configs"], cell["config"],
                        "config")["reduced"] == ["decoder_layers"]


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_jax_and_a_reference_of_plain_torch():
    files = [HERE / "entries" / "graph_block.py", HERE / "whisper_reference.py"]
    files += [HERE / "metrics" / f"{m}.py" for m in NEW_METRICS]
    for path in files:
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path
    assert _imports(HERE / "whisper_reference.py") <= \
        {"__future__", "math", "torch", "portbench"}
