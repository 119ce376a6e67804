"""The ``resnet50-1x1-fwd-bf16`` cell on the CPU, cut to a small layer list:
its configuration against the reference's layers and the hand-worked
operations, ``correct`` true for the sound path and false for the control
and for a fault planted under the timed path, its metrics (one of its own,
thirteen accepted ones whose readers read it too), and its files'
imports."""
from __future__ import annotations

import ast
import time
from pathlib import Path

import pytest
import torch

from portbench import counts, harness, resnet_reference

HERE = Path(harness.__file__).resolve().parent
CELL = "resnet50-1x1-fwd-bf16"
NEW_METRICS = {"extract_us.span"}
#: the accepted per-layer metrics whose readers read this cell too
SHARED_METRICS = {"compile_s", "compile_s.span", "k1_roofline", "mfu.p95",
                  "tflops.p95", "device_idle.p95", "plan_us.span",
                  "memo_hit.plan", "launch_us.span", "launches.req",
                  "device_idle.plan", "device_idle.launch",
                  "device_idle.outside"}
#: the configuration cut for the CPU (the card runs it whole): one square
#: layer, a wide one and a deep one, a batch of 2
SMALL = {"batch": 2, "layers": [
    {"stage": 2, "block": 0, "role": "reduce", "h": 6, "w": 5, "cin": 16,
     "cout": 16},
    {"stage": 2, "block": 0, "role": "expand", "h": 4, "w": 4, "cin": 16,
     "cout": 64},
    {"stage": 2, "block": 1, "role": "reduce", "h": 3, "w": 7, "cin": 64,
     "cout": 8}]}


def small_cell() -> harness.Cell:
    cell = harness.load_cell(harness.load_benchmark(), CELL)
    cell.config.update(SMALL)
    return cell


def run_small(cell=None, control: bool = False, trace: bool = False,
              seed: int = 2**31 + 13) -> dict:
    return harness.run_cell(cell or small_cell(), seed, 0.3, trace,
                            torch.device("cpu"), time.perf_counter(),
                            control=control)


def test_the_configuration_is_the_references_layers_by_hand():
    c = harness.load_json("configs", "resnet50-1x1-gemm")
    assert c["layers"] == resnet_reference.pointwise_convs()
    assert [sum(l["stage"] == s for l in c["layers"]) for s in (2, 3, 4, 5)] \
        == [7, 8, 12, 6]
    B = c["batch"]
    shapes = [(B * l["h"] * l["w"], l["cout"], l["cin"]) for l in c["layers"]]
    assert [tuple(g) for g in c["gemms"]] == list(dict.fromkeys(shapes))
    assert len(c["gemms"]) == 12
    # a 1x1 conv: one multiply and one add per output and input channel
    want = sum(2 * B * l["h"] * l["w"] * l["cin"] * l["cout"]
               for l in c["layers"])
    assert sum(counts.gemm_flops(*s) for s in shapes) == want
    assert want / 1e9 == pytest.approx(101.42, abs=0.005)


def test_work_and_flops_are_the_configurations_shapes():
    cell = small_cell()
    entry = cell.entry_mod.Entry(cell.config, cell.traffic, 5,
                                 torch.device("cpu"))
    want = [(2 * 6 * 5, 16, 16), (2 * 4 * 4, 64, 16), (2 * 3 * 7, 8, 64)]
    assert entry.classes == ["pass"]
    assert entry.work((0, 1)) == {"k1": want}
    assert entry.flops((0, 1)) == sum(2 * m * n * k for m, n, k in want)
    assert [tuple(x.shape) for x in entry.x[3]] == \
        [(2, 6, 5, 16), (2, 4, 4, 16), (2, 3, 7, 64)]


def test_the_copy_is_the_programs_reference():
    from repro_torch.models import resnet50_1x1_reference as program
    assert resnet_reference.pointwise_convs() == program.pointwise_convs()
    w = [m.init_weight(24, 40, torch.Generator().manual_seed(3))
         for m in (resnet_reference, program)]
    assert torch.equal(*w)
    x = torch.randn(2, 3, 4, 24, generator=torch.Generator().manual_seed(4))
    assert torch.equal(resnet_reference.conv1x1(x, w[0]),
                       program.conv1x1(x, w[1]))


def test_sound_run_is_correct():
    out = run_small()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == {"rel_rms"}
    assert set(out["metrics"]) == {"p95_ms", "setup_s"}


def test_control_is_not_correct():
    assert not run_small(control=True)["correct"]


def test_a_transposed_filter_is_not_correct():
    """The square layer's filter read as its transpose, under
    ``ops.scheduled_conv``."""
    cell = small_cell()
    sound = cell.entry_mod.scheduled_conv
    faulty = []

    def broken(x, w, graph=None):
        if w.shape[2] == w.shape[3]:
            faulty.append(w)
            w = w.transpose(2, 3).contiguous()
        return sound(x, w, graph)
    cell.entry_mod.scheduled_conv = broken
    out = run_small(cell)
    assert faulty and out["failed"] == 0 and not out["correct"], \
        out["checks"]


def test_traced_run_reads_the_cells_metrics_on_the_cpu():
    out = run_small(trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    # the device-trace readers need the card; the others read on the CPU
    assert set(m) == {"compile_s", "compile_s.span", "tflops.p95",
                      "plan_us.span", "memo_hit.plan", "launch_us.span",
                      "launches.req", "extract_us.span"}
    assert m["memo_hit.plan"]["value"] == 100.0
    assert 0 < m["extract_us.span"]["value"] < m["plan_us.span"]["value"]
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
            assert CELL in m["workloads"]
        else:
            assert CELL not in m["workloads"]
    cell = harness.find(bench["workloads"], CELL, "workload")
    assert cell["chips"] == 1
    assert harness.find(bench["configs"], cell["config"],
                        "config")["reduced"] == ["projection_stride2"]


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_jax_and_a_reference_of_plain_torch():
    files = [HERE / "entries" / "scheduled_conv.py",
             HERE / "resnet_reference.py"]
    files += [HERE / "metrics" / f"{m}.py" for m in NEW_METRICS]
    for path in files:
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path
    assert _imports(HERE / "resnet_reference.py") <= \
        {"__future__", "math", "torch", "portbench"}
