"""The port's static verifier and persistent artifact cache against the JAX
package's: on the modeled GPU (``gpu_sm(8)``, the port's only target) both
verifiers give the same report for every gemm and gru case of the tune
suite, both compiles reject a corrupted schedule with the same rule ids,
and the port's ``ArtifactCache`` hits, misses and replays as the JAX one
does (``tests/test_compile.py``, ``tests/test_verify.py``), in a file of its
own.  Every cache here lives under ``tmp_path``."""
import json
import os
import warnings

import pytest

from repro.compile import compile_gemm as jax_compile_gemm
from repro.compile import compile_selection as jax_compile_selection
from repro.compile.artifact import CompileError as JaxCompileError
from repro.compile.cache import default_artifact_cache_path as jax_cache_path
from repro.compile.pipeline import CompileContext as JaxContext
from repro.compile.pipeline import VerifyPass as JaxVerifyPass
from repro.core.sysgraph import gpu_sm as jax_gpu_sm
from repro.search.space import ParamApproach as JaxParamApproach
from repro.search.tune import build_cases as jax_build_cases
from repro.verify import RULES as JAX_RULES
from repro.verify import verify_compile as jax_verify_compile
from repro_torch.compile import (ArtifactCache, CompileError,
                                 compile_gemm, compile_gru, compile_program,
                                 compile_selection,
                                 default_artifact_cache_path,
                                 get_default_artifact_cache,
                                 set_default_artifact_cache)
from repro_torch.compile import cache as cache_mod
from repro_torch.compile import keys, pipeline
from repro_torch.compile.driver import clear_memo
from repro_torch.compile.keys import approach_fingerprint, artifact_key
from repro_torch.compile.pipeline import (DEFAULT_PASSES, CompileContext,
                                          VerifyPass)
from repro_torch.core import instructions as I
from repro_torch.core import kernels_ir as K
from repro_torch.core.approach import GreedyApproach
from repro_torch.core.sysgraph import gpu_sm
from repro_torch.search.evaluate import validate_schedule
from repro_torch.search.space import ParamApproach
from repro_torch.search.tune import build_cases
from repro_torch.verify import (ERROR, RULES, WARNING, Diagnostic,
                                DiagnosticReport, diag, verify_artifact,
                                verify_compile)

GRAPH = gpu_sm(8)
JAX_GRAPH = jax_gpu_sm(8)
CASES = build_cases("gemm") + build_cases("gru")
JAX_CASES = {c.name: c for c in jax_build_cases("gemm")
             + jax_build_cases("gru")}
#: a config whose staging budget the greedy schedules overrun, so that the
#: report is not empty: ``sch.vmem-budget`` warnings
TIGHT = {"vmem_frac": 0.25}


@pytest.fixture(autouse=True)
def _isolate_caches():
    """No test leaks a process-default artifact cache or a stale memo."""
    clear_memo()
    set_default_artifact_cache(None)
    yield
    clear_memo()
    set_default_artifact_cache(None)


def rows(report):
    return [(d.rule, d.severity, d.message) for d in report.diagnostics]


# --------------------------------------------------------------------------- #
# The verifier against the JAX package's
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_verify_compile_matches_jax_package(case):
    """Same report, by rule id, severity and message: clean for the greedy
    compile, and the same warnings when the schedule is held to a quarter
    of the staging memory."""
    ref = JAX_CASES[case.name]
    art = compile_selection(case.selection, GRAPH, program=case.program,
                            verify=True)
    jax_art = jax_compile_selection(ref.selection, JAX_GRAPH,
                                    program=ref.program, verify=True)
    got = verify_compile(selection=case.selection, schedule=art.schedule,
                         approach=art.approach)
    want = jax_verify_compile(selection=ref.selection,
                              schedule=jax_art.schedule,
                              approach=jax_art.approach)
    assert rows(got) == rows(want) == []
    tight = verify_compile(selection=case.selection, schedule=art.schedule,
                           approach=ParamApproach(TIGHT))
    jax_tight = jax_verify_compile(selection=ref.selection,
                                   schedule=jax_art.schedule,
                                   approach=JaxParamApproach(TIGHT))
    assert rows(tight) == rows(jax_tight)
    assert tight.ok == jax_tight.ok


def test_tight_budget_report_is_not_empty():
    """The parity above compares warnings, not only empty reports."""
    case = CASES[0]
    art = compile_selection(case.selection, GRAPH, program=case.program)
    report = verify_compile(selection=case.selection, schedule=art.schedule,
                            approach=ParamApproach(TIGHT))
    assert report.warnings and report.ok
    assert {d.rule for d in report.warnings} == {"sch.vmem-budget"}


def test_default_pipeline_verifies_before_lower():
    names = [p.name for p in DEFAULT_PASSES]
    assert names == ["map", "select", "schedule", "verify", "lower"]


def test_artifact_verifies_clean_end_to_end():
    art = compile_gemm(256, 128, 192, use_cache=False)
    report = verify_artifact(art)
    assert report.ok and report.diagnostics == [], report.render()


# --------------------------------------------------------------------------- #
# A corrupted schedule: rejected by both, with the same rule ids
# --------------------------------------------------------------------------- #


def _corrupt_schedule(sched):
    wb = [op for op in sched.ops if op.kind == "writeback"][-1]
    sched.ops = [op for op in sched.ops if op.uid != wb.uid]
    sched.final_residency.pop((wb.region.buffer, wb.region.bounds), None)


def _rules(message):
    return sorted({r for r in RULES if r in message})


def test_verify_pass_rejects_corrupt_schedule_as_jax_does():
    art = compile_gemm(128, 64, 96, use_cache=False)
    jax_art = jax_compile_gemm(128, 64, 96, graph=JAX_GRAPH, use_cache=False)
    _corrupt_schedule(art.schedule)
    _corrupt_schedule(jax_art.schedule)
    ctx = CompileContext(program=art.program, graph=art.graph,
                         approach=art.approach)
    ctx.selection, ctx.schedule = art.selection, art.schedule
    jctx = JaxContext(program=jax_art.program, graph=jax_art.graph,
                      approach=jax_art.approach)
    jctx.selection, jctx.schedule = jax_art.selection, jax_art.schedule
    with pytest.raises(CompileError, match="sch.output-not-home") as got:
        VerifyPass().run(ctx)
    with pytest.raises(JaxCompileError) as want:
        JaxVerifyPass().run(jctx)
    assert _rules(str(got.value)) == _rules(str(want.value))
    assert rows(verify_compile(selection=art.selection,
                               schedule=art.schedule,
                               approach=art.approach)) == \
        rows(jax_verify_compile(selection=jax_art.selection,
                                schedule=jax_art.schedule,
                                approach=jax_art.approach))
    ctx.verify = False                         # the escape hatch
    VerifyPass().run(ctx)


def test_default_compile_rejects_a_corrupt_schedule(monkeypatch):
    """The strict default: a scheduler that loses the output's writeback
    makes ``compile_gemm`` raise, and ``verify=False`` lets it through."""
    real = pipeline.schedule

    def corrupted(*args, **kw):
        sched = real(*args, **kw)
        _corrupt_schedule(sched)
        return sched

    monkeypatch.setattr(pipeline, "schedule", corrupted)
    with pytest.raises(CompileError, match="sch.output-not-home"):
        compile_gemm(128, 64, 96, use_cache=False)
    with pytest.raises(CompileError, match="sch.output-not-home"):
        compile_program(K.matmul(64, 32, 48), isa=[I.mxu_matmul()],
                        allow_transforms=False, use_cache=False)
    assert compile_gemm(128, 64, 96, use_cache=False, verify=False).cost > 0


def test_compile_selection_verify_is_opt_in(monkeypatch):
    case = CASES[0]
    assert compile_selection(case.selection, GRAPH, program=case.program,
                             verify=True).cost > 0
    real = pipeline.schedule

    def corrupted(*args, **kw):
        sched = real(*args, **kw)
        _corrupt_schedule(sched)
        return sched

    monkeypatch.setattr(pipeline, "schedule", corrupted)
    compile_selection(case.selection, GRAPH, program=case.program)
    with pytest.raises(CompileError, match="sch.output-not-home"):
        compile_selection(case.selection, GRAPH, program=case.program,
                          verify=True)


# --------------------------------------------------------------------------- #
# Diagnostics: structure + JSON round-trip
# --------------------------------------------------------------------------- #


def test_rules_table_is_the_jax_package_one():
    assert RULES == JAX_RULES
    for rule in RULES:
        assert rule.split(".", 1)[0] in ("prg", "sel", "sch", "fab", "gra",
                                         "srv", "art")


def test_diag_rejects_unregistered_rule():
    with pytest.raises(KeyError):
        diag("prg.not-a-rule", "nope")


def test_diagnostic_layer_derived_from_rule():
    d = diag("sch.capacity", "too big", uid=7, subject="smem")
    assert d.layer == "sch" and d.severity == ERROR


def test_diagnostic_json_round_trip():
    d = diag("sel.axis-role", "axis j bound twice", severity=WARNING,
             subject="mxu.matmul", uid=3)
    d2 = Diagnostic.from_dict(json.loads(json.dumps(d.to_dict())))
    assert d2 == d


def test_report_json_round_trip_and_severity_split():
    rep = DiagnosticReport(meta={"case": "gemm"})
    rep.extend([diag("prg.bounds", "oob"),
                diag("sch.vmem-budget", "tight", severity=WARNING)])
    assert not rep.ok and len(rep.errors) == 1 and len(rep.warnings) == 1
    rep2 = DiagnosticReport.from_dict(json.loads(json.dumps(rep.to_dict())))
    assert rep2.diagnostics == rep.diagnostics
    assert rep2.meta == {"case": "gemm"}
    assert "prg.bounds" in rep.render()


# --------------------------------------------------------------------------- #
# The persistent artifact cache
# --------------------------------------------------------------------------- #


def test_same_program_sysgraph_hits_cache(tmp_path):
    cache = ArtifactCache(str(tmp_path / "compiled.json"))
    a1 = compile_gemm(256, 128, 192, cache=cache)
    assert not a1.from_cache
    clear_memo()                       # force the persistent layer
    a2 = compile_gemm(256, 128, 192, cache=cache)
    assert a2.from_cache
    assert a2.key == a1.key
    assert a2.cost == a1.cost
    assert a2.gemm_tile() == a1.gemm_tile()
    assert a2.lowering == a1.lowering


def test_default_cache_is_opt_in(tmp_path):
    assert get_default_artifact_cache() is None
    compile_gemm(64, 32, 48)           # no cache activated: nothing written
    cache = ArtifactCache(str(tmp_path / "compiled.json"))
    set_default_artifact_cache(cache)
    art = compile_gru(4, 16)
    assert art.key in ArtifactCache(cache.path)
    assert not os.path.exists(tmp_path / "other.json")


def test_changed_sysgraph_misses(tmp_path):
    cache = ArtifactCache(str(tmp_path / "compiled.json"))
    a1 = compile_gemm(256, 128, 192, cache=cache)
    clear_memo()
    a2 = compile_gemm(256, 128, 192, graph=gpu_sm(4), cache=cache)
    assert not a2.from_cache
    assert a2.key != a1.key


def test_changed_backend_and_approach_miss():
    prog = K.matmul(64, 64, 64)
    greedy = GreedyApproach()
    base = artifact_key(prog, GRAPH, greedy, "cost")
    assert artifact_key(prog, GRAPH, greedy, "measure") != base
    tuned = ParamApproach({"tile_i": 256})
    assert artifact_key(prog, GRAPH, tuned, "cost") != base


def test_changed_isa_or_transform_policy_misses():
    prog = K.gru_cell(4, 16, 16)
    full = compile_program(prog, isa=I.tpu_isa())
    unfused = compile_program(prog, isa=I.tpu_isa(include_fused=False))
    assert full.key != unfused.key
    assert any(p.needle.startswith("fused.") for p in full.instrs)
    assert not any(p.needle.startswith("fused.") for p in unfused.instrs)
    mm = K.matmul(64, 64, 64)
    assert artifact_key(mm, GRAPH, GreedyApproach(), "cost",
                        [I.mxu_matmul()], True) != \
        artifact_key(mm, GRAPH, GreedyApproach(), "cost",
                     [I.mxu_matmul()], False)


def test_changed_torch_version_misses(tmp_path, monkeypatch):
    cache = ArtifactCache(str(tmp_path / "compiled.json"))
    compile_gemm(256, 128, 192, cache=cache)
    clear_memo()
    monkeypatch.setattr(keys, "torch_version", lambda: "99.0.0-test")
    a2 = compile_gemm(256, 128, 192, cache=cache)
    assert not a2.from_cache
    assert "torch=99.0.0-test" in a2.key


def test_opaque_approach_never_cached(tmp_path):
    class Wrapped(GreedyApproach):
        pass
    cache = ArtifactCache(str(tmp_path / "compiled.json"))
    assert approach_fingerprint(Wrapped()).startswith("opaque:")
    compile_gemm(64, 64, 64, approach=Wrapped(), cache=cache)
    assert len(cache) == 0


def test_cached_artifact_replays_bit_exact(tmp_path):
    """A cache-hydrated artifact rebuilds a schedule whose executor replay
    is bit-exact against the ISAMIR oracle."""
    cache = ArtifactCache(str(tmp_path / "compiled.json"))
    m, n, k = 96, 80, 130                       # odd k: boundary tiles
    compile_gemm(m, n, k, cache=cache)
    clear_memo()
    art = compile_gemm(m, n, k, cache=ArtifactCache(cache.path))
    assert art.from_cache and art.schedule is None
    sched = art.ensure_schedule()
    report = validate_schedule(K.matmul(m, n, k), art.selection, sched)
    assert report.exact
    assert sched.makespan == art.cost


def test_cached_gru_artifact_replays_bit_exact(tmp_path):
    cache = ArtifactCache(str(tmp_path / "compiled.json"))
    compile_gru(4, 16, cache=cache)
    clear_memo()
    art = compile_gru(4, 16, cache=ArtifactCache(cache.path))
    assert art.from_cache
    sched = art.ensure_schedule()
    report = validate_schedule(art.program, art.selection, sched)
    assert report.ok
    assert sched.makespan == art.cost


def test_cache_roundtrip_through_json(tmp_path):
    path = str(tmp_path / "compiled.json")
    a1 = compile_gemm(128, 64, 64, cache=ArtifactCache(path))
    raw = json.loads(open(path).read())
    assert raw["schema"] == 1 and len(raw["artifacts"]) == 1
    clear_memo()
    a2 = ArtifactCache(path).lookup(a1.key)
    assert a2 is not None
    assert a2.to_dict() == a1.to_dict()
    assert [p.needle for p in a2.instrs] == [p.needle for p in a1.instrs]


def test_corrupt_artifact_cache_warns_once(tmp_path):
    path = tmp_path / "compiled.json"
    path.write_text("{definitely not json")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c = ArtifactCache(str(path))
        assert len(c) == 0
        ArtifactCache(str(path)).load()         # second reader: no new warn
    assert len([w for w in caught if "corrupt" in str(w.message)]) == 1
    # a corrupt cache degrades to empty, then heals on the next save
    art = compile_gemm(64, 64, 64, cache=c)
    clear_memo()
    assert ArtifactCache(str(path)).lookup(art.key) is not None


def test_cache_lookup_rejects_corrupt_payload(tmp_path, recwarn):
    art = compile_gemm(64, 32, 48, use_cache=False)
    path = str(tmp_path / "compiled.json")
    ArtifactCache(path).store(art)
    assert ArtifactCache(path).lookup(art.key) is not None
    with open(path) as f:
        payload = json.load(f)
    payload["artifacts"][0]["cost"] = -1.0      # corrupt on disk
    with open(path, "w") as f:
        json.dump(payload, f)
    assert ArtifactCache(path).lookup(art.key) is None
    assert any("failed payload verification" in str(w.message)
               for w in recwarn.list)
    clear_memo()                               # the compile recompiles
    again = compile_gemm(64, 32, 48, cache=ArtifactCache(path))
    assert not again.from_cache and again.cost == art.cost


def test_default_path_and_env_var_are_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv(cache_mod.CACHE_ENV_VAR, raising=False)
    monkeypatch.delenv("REPRO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    path = default_artifact_cache_path()
    assert path == str(tmp_path / ".cache" / "repro_torch" / "compiled.json")
    assert path != jax_cache_path()
    assert ArtifactCache().path == path
    assert cache_mod.CACHE_ENV_VAR == "REPRO_TORCH_COMPILE_CACHE"
    monkeypatch.setenv("REPRO_COMPILE_CACHE", str(tmp_path / "jax.json"))
    assert default_artifact_cache_path() == path   # the JAX variable: ignored
    monkeypatch.setenv(cache_mod.CACHE_ENV_VAR, str(tmp_path / "port.json"))
    assert default_artifact_cache_path() == str(tmp_path / "port.json")
    assert not (tmp_path / ".cache").exists()
