"""The port's conv frontend against the JAX package's: ``compile_conv``
artifacts (the conv→matmul extraction of the paper's abstract and Fig. 5)
on ``tpu_v5e(1)`` and ``gpu_sm(8)``, the tuner's ``conv`` suite and a
``--suite conv`` tune report, all equal on the same inputs.  Then the
bridge from that extraction to K1 on the CPU: ``ops.plan_conv`` at
ResNet-50's pointwise shapes, ``ops.scheduled_conv`` against the plain
reference (``models.resnet50_1x1_reference``), what it refuses, its
spans and its counters."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.compile import compile_conv as jax_compile_conv
from repro.core import sysgraph as jax_sysgraph
from repro.search import tune as jax_tune
from repro_torch import telemetry
from repro_torch.compile import (ArtifactCache, CompileError, compile_conv,
                                 conv_selection)
from repro_torch.compile.driver import clear_memo
from repro_torch.compile.features import role_extents
from repro_torch.core import sysgraph
from repro_torch.kernels import ops
from repro_torch.kernels.gemm import gemm_route
from repro_torch.models import resnet50_1x1_reference as R
from repro_torch.search import tune

FIELDS = ("lowering", "cost", "counts", "bytes_moved", "program_fp",
          "graph_fp", "program_name", "graph_name", "approach_fp")
TARGETS = [("tpu_v5e", 1), ("gpu_sm", 8)]
#: the tuner's cases, a strided conv, and the 1x1 conv of
#: ``tests/test_compile.py::test_conv_extraction_tile_not_128_default``
CONVS = {name: kw for name, kw in tune.CONV_CASES}
CONVS["strided3x3"] = dict(batch=2, h=5, w=5, kh=3, kw=3, cin=8, cout=16,
                           stride=2)
CONVS["small1x1"] = dict(batch=2, h=6, w=6, kh=1, kw=1, cin=8, cout=8)


def assert_same_artifact(port, ref):
    for f in FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert [p.to_dict() for p in port.instrs] == \
        [p.to_dict() for p in ref.instrs]


def payload(art):
    return {k: v for k, v in art.to_dict().items() if k != "meta"}


@pytest.mark.parametrize("target,arg", TARGETS)
@pytest.mark.parametrize("name", list(CONVS))
def test_conv_artifact_matches_jax_package(name, target, arg):
    kw = CONVS[name]
    port = compile_conv(graph=getattr(sysgraph, target)(arg),
                        use_cache=False, **kw)
    ref = jax_compile_conv(graph=getattr(jax_sysgraph, target)(arg),
                           use_cache=False, **kw)
    assert_same_artifact(port, ref)
    assert port.meta["frontend"] == "conv"
    assert port.meta["frontend_args"] == kw


@pytest.mark.parametrize("target,arg", TARGETS)
def test_conv_extraction_tile_is_the_fused_extents(target, arg):
    """The extraction renames haystack axes; the role-derived tile reflects
    the real fused extents (b*y*x = 72, cout, cin), not a 128 default."""
    art = compile_conv(graph=getattr(sysgraph, target)(arg), use_cache=False,
                       **CONVS["small1x1"])
    plan = art.instr_plan("mxu.matmul")
    assert not {"i", "j", "k"} <= {h for _, h in plan.axis_map}
    assert art.gemm_tile() == (72, 8, 8)
    assert role_extents(art.selection) == {"i": 72, "j": 8, "k": 8}
    assert plan.calls == 1
    assert [s.name for s in art.selection.steps] == [
        "drop_unit_axes", "fuse_axes(y,x)", "fuse_axes(b,yx)"]


def test_conv_selection_keeps_the_original_program():
    orig, sel = conv_selection(**CONVS["conv3x3"])
    assert orig.name == "conv2d"
    assert sel.complete
    assert sum(1 for si in sel.instrs if "matmul" in si.needle.name) == 1


def test_conv_cache_replay(tmp_path):
    """A conv artifact served by the persistent cache equals the fresh
    compile, and its schedule rebuilds through the conv frontend."""
    path = str(tmp_path / "compiled.json")
    kw = CONVS["conv1x1"]
    clear_memo()
    fresh = compile_conv(cache=ArtifactCache(path), **kw)
    clear_memo()
    hit = compile_conv(cache=ArtifactCache(path), **kw)
    assert not fresh.from_cache and hit.from_cache
    assert payload(hit) == payload(fresh)
    assert hit.selection is None
    assert hit.ensure_schedule().makespan == fresh.cost
    assert [s.name for s in hit.selection.steps] == \
        [s.name for s in fresh.selection.steps]


@pytest.mark.parametrize("suite", ["conv", "all"])
def test_build_cases_match_jax_package(suite):
    port = tune.build_cases(suite)
    ref = jax_tune.build_cases(suite)
    assert [c.name for c in port] == [c.name for c in ref]
    for p, r in zip(port, ref):
        assert p.program.signature() == r.program.signature()
        assert p.original.signature() == r.original.signature()
        assert p.proxy_original.signature() == r.proxy_original.signature()
        assert [s.name for s in p.selection.steps] == \
            [s.name for s in r.selection.steps]
        assert [si.needle.name for si in p.selection.instrs] == \
            [si.needle.name for si in r.selection.instrs]
        assert p.gemm_shape == r.gemm_shape
    if suite == "conv":
        assert all(c.gemm_shape is None for c in port)


def test_conv_tune_report_matches_jax_package(tmp_path):
    common = ["--suite", "conv", "--trials", "4", "--seed", "0",
              "--target", "gpu_sm"]
    assert tune.main([*common, "--cache", str(tmp_path / "port.json"),
                      "--json", str(tmp_path / "port_report.json")]) == 0
    assert jax_tune.main([*common, "--cache", str(tmp_path / "jax.json"),
                          "--json", str(tmp_path / "jax_report.json")]) == 0
    port = json.loads((tmp_path / "port_report.json").read_text())
    ref = json.loads((tmp_path / "jax_report.json").read_text())
    assert (port["suite"], port["strategy"], port["graph"],
            port["failures"]) == (ref["suite"], ref["strategy"],
                                  ref["graph"], ref["failures"]) == (
        "conv", "hillclimb", "gpu_sm_x8", 0)
    assert len(port["rows"]) == len(ref["rows"]) == len(tune.CONV_CASES)
    for p, r in zip(port["rows"], ref["rows"]):
        for f in ("case", "greedy_cost_s", "tuned_cost_s", "speedup",
                  "trials", "strategy", "config", "validated", "exact",
                  "max_abs_err"):
            assert p[f] == r[f], f
        assert p["key"].rpartition("|")[0] == r["key"].rpartition("|")[0]
        assert p["backend"] == "cost"
    records = json.loads((tmp_path / "port.json").read_text())["records"]
    jax_records = json.loads((tmp_path / "jax.json").read_text())["records"]
    assert [(r["config"], r["cost"], r["baseline_cost"], r.get("tile"))
            for r in records] == \
        [(r["config"], r["cost"], r["baseline_cost"], r.get("tile"))
         for r in jax_records]
    assert all(r.get("tile") is None for r in records)    # no GEMM block


# --------------------------------------------------------------------------- #
# The bridge: the extraction's GEMM on K1 (``ops.plan_conv``,
# ``ops.scheduled_conv``), on the CPU path
# --------------------------------------------------------------------------- #

#: the 12 distinct (h, w, cin, cout) of ResNet-50's 33 stride-1 1x1 convs
RESNET_1X1 = list(dict.fromkeys((c["h"], c["w"], c["cin"], c["cout"])
                                for c in R.pointwise_convs()))
#: K1's tolerances on the card (``tests/test_torch_gpu.py``); f32's atol
#: scales with max |y|
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def conv_inputs(batch, h, w, cin, cout, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, h, w, cin), generator=gen)
    return x.to(dtype), R.init_weight(cin, cout, gen).to(dtype)


def counted(name: str) -> int:
    return telemetry.counters()[name]


def test_the_reference_imports_torch_alone():
    tree = ast.parse(Path(R.__file__).read_text())
    tops = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert tops <= {"__future__", "math", "torch"}


def test_pointwise_convs_are_resnet50s():
    convs = R.pointwise_convs()
    assert len(convs) == 33 and len(RESNET_1X1) == 12
    assert [sum(c["stage"] == s for c in convs) for s in (2, 3, 4, 5)] == \
        [7, 8, 12, 6]
    assert sum(c["role"] == "projection" for c in convs) == 1
    gflop = sum(2 * 28 * c["h"] * c["w"] * c["cin"] * c["cout"]
                for c in convs) / 1e9
    assert gflop == pytest.approx(101.42, abs=0.005)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 5, 16, 24), (1, 4, 4, 64, 8),
                                   (3, 7, 3, 8, 40)])
def test_scheduled_conv_matches_the_reference(shape, dtype):
    x, w = conv_inputs(*shape, dtype)
    y, cfg = ops.scheduled_conv(x, w)
    want = R.conv1x1(x, w)
    assert y.shape == want.shape and y.dtype == dtype
    tol = dict(TOL[dtype])
    if dtype == torch.float32:
        tol["atol"] *= float(want.abs().max())
    np.testing.assert_allclose(y.double().numpy(), want.numpy(), **tol)
    assert cfg.route == gemm_route(dtype, shape[3]).name


def test_scheduled_conv_runs_k1_on_views_of_x_and_w(monkeypatch):
    x, w = conv_inputs(2, 6, 5, 16, 24, torch.bfloat16)
    sound, seen = ops.gemm, []

    def spy(a, b, tile=None):
        seen.append((a, b, sound(a, b, tile=tile)))
        return seen[-1][2]
    monkeypatch.setattr(ops, "gemm", spy)
    before = counted("conv.gemm")
    y, cfg = ops.scheduled_conv(x, w)
    assert counted("conv.gemm") == before + 1 and len(seen) == 1
    a, b, c = seen[0]
    assert a.shape == (60, 16) and b.shape == (16, 24)
    assert a.data_ptr() == x.data_ptr() and b.data_ptr() == w.data_ptr()
    assert y.data_ptr() == c.data_ptr()
    assert cfg.tile == ops.plan_conv(2, 6, 5, 16, 24, torch.bfloat16)[0].tile


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,cin,cout", RESNET_1X1)
def test_plan_conv_at_the_resnet_shapes(h, w, cin, cout, dtype):
    cfg, cost = ops.plan_conv(28, h, w, cin, cout, dtype)
    art = compile_conv(approach="greedy", batch=28, h=h, w=w, kh=1, kw=1,
                       cin=cin, cout=cout)
    assert art.lowering == {"kind": "stream"}          # not what is read
    shape = (28 * h * w, cout, cin)
    block, got_shape = ops.conv_gemm(art, 28, h, w, cin, cout)
    assert got_shape == shape
    assert block == cfg.block == tuple(
        min(t, e) for t, e in zip(art.gemm_tile(), shape))
    assert cfg == ops.launch_config(
        {"kind": "pallas_gpu_gemm", "block": list(block),
         "grid": [-(-e // b) for e, b in zip(shape, block)]}, dtype, shape)
    assert cost == art.cost


def _stride2():
    art = compile_conv(approach="greedy", batch=2, h=3, w=3, kh=1, kw=1,
                       cin=8, cout=16, stride=2)
    ops.conv_gemm(art, 2, 3, 3, 8, 16)


def _three_by_three():
    x, _ = conv_inputs(2, 5, 5, 8, 16, torch.float32)
    ops.scheduled_conv(x, torch.randn(3, 3, 8, 16))


def _x_not_contiguous():
    x = torch.randn(2, 8, 5, 5).permute(0, 2, 3, 1)
    ops.scheduled_conv(x, torch.randn(1, 1, 8, 16))


def _w_not_contiguous():
    x, _ = conv_inputs(2, 5, 5, 8, 16, torch.float32)
    ops.scheduled_conv(x, torch.randn(1, 1, 16, 8).transpose(2, 3))


@pytest.mark.parametrize("case", [_stride2, _three_by_three,
                                  _x_not_contiguous, _w_not_contiguous])
def test_what_is_not_one_gemm_on_views_raises(case):
    before = counted("conv.gemm"), counted("gemm.launches")
    with pytest.raises(CompileError):
        case()
    assert (counted("conv.gemm"), counted("gemm.launches")) == before


def test_the_span_tree_of_scheduled_conv():
    x, w = conv_inputs(2, 6, 5, 16, 24, torch.float32)
    ops.scheduled_conv(x, w)                       # the memo warm
    with telemetry.recording() as rec:
        ops.scheduled_conv(x, w)
    spans = rec.spans()
    assert [(s.name, spans[s.parent].name if s.parent >= 0 else None)
            for s in spans] == [
        ("ops.conv", None), ("ops.plan", "ops.conv"),
        ("compile.conv", "ops.plan"), ("compile.memo", "compile.conv"),
        ("compile.memo", "compile.conv"), ("plan.extract", "ops.plan"),
        ("plan.launch", "ops.plan"), ("k1", "ops.conv"), ("k1.check", "k1")]


def test_a_warm_plan_is_a_memo_hit_and_each_conv_counts_once():
    clear_memo()
    before = telemetry.counters()
    ops.plan_conv(2, 4, 4, 8, 8)
    ops.plan_conv(2, 4, 4, 8, 8)
    x, w = conv_inputs(2, 4, 4, 8, 8, torch.float32)
    ops.scheduled_conv(x, w)
    ops.scheduled_conv(x, w)
    after = telemetry.counters()
    got = {k: after[k] - before[k] for k in ("compile.memo_hit",
                                             "compile.memo_sig",
                                             "compile.fresh", "conv.gemm")}
    assert got == {"compile.memo_hit": 3, "compile.memo_sig": 3,
                   "compile.fresh": 1, "conv.gemm": 2}
