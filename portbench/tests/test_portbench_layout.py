"""The benchmark's files are found by name, its counts are the hand-worked
ones, and nothing under ``portbench/`` imports JAX or the JAX package."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench import counts, harness, peaks
from portbench.metrics import k1_roofline, k4_roofline

HERE = Path(harness.__file__).resolve().parent


def test_every_cell_resolves_by_name():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        cell = harness.load_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert hasattr(cell.entry_mod, "Entry")
        assert set(cell.traffic["limits"]) and cell.e2e and cell.per_layer
        for m in cell.e2e + cell.per_layer:
            assert callable(harness.load_code("metrics", m["name"]).read)


def test_every_file_parses():
    for path in (HERE / "configs").glob("*.json"):
        assert harness.load_json("configs", path.stem)["name"] == path.stem
    for path in (HERE / "traffic").glob("*.json"):
        assert harness.load_json("traffic", path.stem)["entry"]
    for path in (HERE / "metrics").glob("*.py"):
        harness.load_code("metrics", path.stem)


@pytest.mark.parametrize("folder,loader", [
    ("configs", harness.load_json), ("traffic", harness.load_json),
    ("metrics", harness.load_code), ("entries", harness.load_code)])
def test_unknown_name_fails(folder, loader):
    with pytest.raises(LookupError):
        loader(folder, "no-such-name")


def test_unknown_cell_fails():
    with pytest.raises(LookupError):
        harness.load_cell(harness.load_benchmark(), "no-such-cell")


def test_cell_metrics_follow_their_lists():
    bench = harness.load_benchmark()
    names = {m["name"] for m in
             harness.cell_metrics(bench, "gru-stream-bf16", "per_layer")}
    assert names == {"compile_s", "host_us", "k3_roofline", "mfu",
                     "device_idle"}
    names = {m["name"] for m in
             harness.cell_metrics(bench, "gru-seq-bf16", "end_to_end")}
    assert names == {"tflops", "p95_ms", "setup_s"}
    for cell in ("gemm-f32-pass", "gemm-bf16-call"):
        names = {m["name"] for m in
                 harness.cell_metrics(bench, cell, "end_to_end")}
        assert names == {"p95_ms", "setup_s"}
        names = {m["name"] for m in
                 harness.cell_metrics(bench, cell, "per_layer")}
        assert names == {"compile_s", "plan_us", "host_us", "k1_roofline",
                         "mfu.p95", "tflops.p95", "device_idle.p95"}


def test_every_per_layer_metric_moves_what_its_cells_report():
    bench = harness.load_benchmark()
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            e2e = {e["name"] for e in
                   harness.cell_metrics(bench, cell, "end_to_end")}
            assert m["moves"] in e2e, (m["name"], cell)


def test_counts_match_hand_worked_values():
    gemm = harness.load_json("configs", "deepbench-gemm")["shapes"]
    assert sum(counts.gemm_flops(*s) for s in gemm) / 1e9 == \
        pytest.approx(18.07, abs=0.005)
    assert counts.gru_seq_flops(128, 32, 1792, 1792) / 1e9 == \
        pytest.approx(157.84, abs=0.005)
    # K1 at 7680 x 1 x 2560 in bf16: A, B read once, C written once
    flops, nbytes = k1_roofline.count((7680, 1, 2560), "bfloat16")
    assert nbytes == 2 * (7680 * 2560 + 2560 * 1 + 7680 * 1) == 39_342_080
    assert flops == 2 * 7680 * 2560
    assert peaks.least_seconds(flops, nbytes, "bfloat16") == \
        nbytes / peaks.PEAK_BYTES


def test_k4_reads_u_once():
    _, nbytes = k4_roofline.count((128, 32, 1792), "bfloat16")
    assert nbytes == 2 * (3 * 1792 ** 2 + 1792 + 2 * 32 * 1792) \
        + 4 * 3 * 128 * 32 * 1792


def _imports(path: Path) -> set[str]:
    """Top-level names of every module a file imports (the part before the
    first dot, whole)."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_nothing_imports_jax_or_the_jax_package():
    files = list(HERE.rglob("*.py"))
    assert files
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "peaks.py", "counts.py"):
        assert _imports(HERE / name) <= {"__future__", "math", "torch"}


def test_loaded_modules_are_compared_by_whole_top_level_name(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_probe", types.ModuleType("x"))
    assert harness.loaded_banned() == []
    monkeypatch.setitem(sys.modules, "repro.probe", types.ModuleType("x"))
    assert harness.loaded_banned() == ["repro"]
