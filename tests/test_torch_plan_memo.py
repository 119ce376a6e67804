"""The compiler's signature memo (``repro_torch.compile.driver._SIG``): a warm
``compile_gemm`` / ``compile_gru`` / ``compile_conv`` replays the memoized
artifact without building a graph, a program or a key, and hands out the
artifact the slow path gives; every case that must bypass it does; what it
hands out shares no mutable state; and ``plan_gemm`` still reads the tuning
cache on every call."""
import dataclasses

import pytest

from repro_torch import telemetry
from repro_torch.compile import (compile_conv, compile_gemm, compile_gru,
                                 compile_program, driver)
from repro_torch.compile.driver import clear_memo
from repro_torch.compile.keys import sysgraph_fingerprint
from repro_torch.core import kernels_ir as K
from repro_torch.core.approach import GreedyApproach
from repro_torch.core.sysgraph import gpu_sm
from repro_torch.kernels import ops
from repro_torch.search.cache import (TuningCache, TuningRecord,
                                      gemm_tuning_key, set_default_cache)

FRONTENDS = {
    "gemm": (compile_gemm, dict(m=96, n=40, k=72)),
    "gru": (compile_gru, dict(batch=4, hidden=32)),
    "conv": (compile_conv, dict(batch=2, h=6, w=6, kh=1, kw=1, cin=8,
                                cout=8)),
}
COUNTERS = ("compile.memo_hit", "compile.memo_sig", "compile.fresh")


class Opaque(GreedyApproach):
    """Greedy with a name the keys do not know: never served from a memo."""


@pytest.fixture(params=list(FRONTENDS))
def frontend(request):
    clear_memo()
    yield FRONTENDS[request.param]
    clear_memo()


def counted(fn):
    """(fn's result, the change of the compiler's counters over the call)."""
    before = telemetry.counters()
    out = fn()
    after = telemetry.counters()
    return out, tuple(after[c] - before[c] for c in COUNTERS)


def payload(art):
    return {k: v for k, v in art.to_dict().items() if k != "meta"}


def ops_of(schedule):
    return [(op.uid, op.kind, op.device, op.src, op.dst, op.region, op.tile,
             op.start, op.end) for op in schedule.ops]


def test_a_signature_hit_replays_the_slow_paths_artifact(frontend):
    compile_fn, kw = frontend
    first, got = counted(lambda: compile_fn(**kw))
    assert got == (0, 0, 1)
    hit, got = counted(lambda: compile_fn(**kw))
    assert got == (1, 1, 0)
    # the slow paths: the pipeline run afresh, and the compiler's memo
    # reached through the key (a caller's graph is another signature)
    fresh = compile_fn(use_cache=False, **kw)
    keyed, got = counted(lambda: compile_fn(graph=gpu_sm(8), **kw))
    assert got == (1, 0, 0)
    for want in (fresh, keyed, first):
        assert hit.key == want.key
        assert hit.lowering == want.lowering and hit.cost == want.cost
        assert [p.to_dict() for p in hit.instrs] == \
            [p.to_dict() for p in want.instrs]
    assert payload(hit) == payload(fresh)
    assert hit.from_cache and hit.graph is None and hit.program is not None
    sched = hit.ensure_schedule()
    assert sched.makespan == fresh.cost == fresh.schedule.makespan
    assert ops_of(sched) == ops_of(fresh.schedule)
    assert sysgraph_fingerprint(hit.graph) == fresh.graph_fp


# Each case sets the memo up and returns the call that must bypass it.


def _clear(compile_fn, kw, monkeypatch):
    clear_memo()
    assert not driver._SIG and not driver._MEMO
    return lambda: compile_fn(**kw)


def _overflow(compile_fn, kw, monkeypatch):
    # other programs fill the artifact memo past its cap, which clears it;
    # the signature stays known but its key is gone
    monkeypatch.setattr(driver, "_MEMO_CAP", len(driver._MEMO) + 1)
    compile_program(K.matmul(16, 16, 16))
    compile_program(K.matmul(16, 32, 16))
    assert len(driver._SIG) >= 1 and len(driver._MEMO) == 1
    return lambda: compile_fn(**kw)


def _other_graph(compile_fn, kw, monkeypatch):
    # keyed on the graph's structure, not on the object: a graph mutated
    # in place is another signature
    graph = gpu_sm(8)
    compile_fn(graph=graph, **kw)
    assert counted(lambda: compile_fn(graph=graph, **kw))[1][1] == 1
    graph.memories["host"] = dataclasses.replace(
        graph.memories["host"], capacity=graph.memories["host"].capacity // 2)
    return lambda: compile_fn(graph=graph, **kw)


def _no_cache(compile_fn, kw, monkeypatch):
    return lambda: compile_fn(use_cache=False, **kw)


def _opaque(compile_fn, kw, monkeypatch):
    compile_fn(approach=Opaque(), **kw)
    return lambda: compile_fn(approach=Opaque(), **kw)


@pytest.mark.parametrize("bypass", [_clear, _overflow, _other_graph,
                                    _no_cache, _opaque],
                         ids=["clear_memo", "memo_overflow", "other_graph",
                              "use_cache_false", "opaque_approach"])
def test_the_signature_memo_is_bypassed(frontend, bypass, monkeypatch):
    compile_fn, kw = frontend
    warm = compile_fn(**kw)
    assert counted(lambda: compile_fn(**kw))[1] == (1, 1, 0)
    art, got = counted(bypass(compile_fn, kw, monkeypatch))
    assert got == (0, 0, 1)
    assert not art.from_cache and art.schedule is not None
    if bypass is _other_graph:
        assert art.graph_fp == sysgraph_fingerprint(art.graph)
        assert art.graph_fp != warm.graph_fp
    else:
        assert (art.lowering, art.cost, art.counts) == \
            (warm.lowering, warm.cost, warm.counts)
        assert [p.to_dict() for p in art.instrs] == \
            [p.to_dict() for p in warm.instrs]


def test_a_returned_artifact_shares_no_mutable_state(frontend):
    compile_fn, kw = frontend
    compile_fn(**kw)
    a = compile_fn(**kw)
    a.ensure_schedule().ops.clear()
    a.graph.name = "renamed"
    a.meta["note"] = "mine"
    a.meta["frontend_args"].clear()
    b, got = counted(lambda: compile_fn(**kw))
    assert got == (1, 1, 0)
    assert b.meta == {"frontend": a.meta["frontend"], "frontend_args": kw,
                      "allow_transforms": a.meta["allow_transforms"]}
    assert b.graph is None and b.schedule is None
    assert b.ensure_schedule().ops and b.graph.name == "gpu_sm_x8"
    graph = gpu_sm(8)
    compile_fn(graph=graph, **kw)
    c = compile_fn(graph=graph, **kw)
    assert c.graph is graph
    c.meta["note"] = "mine"
    assert "note" not in compile_fn(graph=graph, **kw).meta


def test_a_tuning_record_activated_between_two_plans_takes_effect(tmp_path):
    m, n, k = 2048, 64, 2048
    block = (512, 64, 483)
    clear_memo()
    set_default_cache(TuningCache(str(tmp_path / "empty.json")))
    try:
        ops.plan_gemm(m, n, k)
        planned, got = counted(lambda: ops.plan_gemm(m, n, k))
        assert got == (1, 1, 0) and planned[0].block != block
        tuned = TuningCache(str(tmp_path / "tuned.json"))
        tuned.store(TuningRecord(
            key=gemm_tuning_key(m, n, k, backend="measure"), config={},
            cost=3e-5, baseline_cost=6e-5, backend="measure", tile=block))
        set_default_cache(tuned)
        (cfg, cost), got = counted(lambda: ops.plan_gemm(m, n, k))
        assert (cfg.block, cost) == (block, 3e-5) and got == (0, 0, 0)
        set_default_cache(TuningCache(str(tmp_path / "empty.json")))
        assert ops.plan_gemm(m, n, k) == planned
    finally:
        set_default_cache(None)
        clear_memo()
