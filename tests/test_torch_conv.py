"""The port's conv frontend against the JAX package's: ``compile_conv``
artifacts (the conv→matmul extraction of the paper's abstract and Fig. 5)
on ``tpu_v5e(1)`` and ``gpu_sm(8)``, the tuner's ``conv`` suite and a
``--suite conv`` tune report, all equal on the same inputs."""
import json

import pytest

from repro.compile import compile_conv as jax_compile_conv
from repro.core import sysgraph as jax_sysgraph
from repro.search import tune as jax_tune
from repro_torch.compile import ArtifactCache, compile_conv, conv_selection
from repro_torch.compile.driver import clear_memo
from repro_torch.compile.features import role_extents
from repro_torch.core import sysgraph
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
