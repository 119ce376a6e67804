"""The port's serving simulator (``repro_torch.serve``, ``verify.serve`` and
the ``srv-*`` mutations) against the JAX package's ``repro.serve``, on the
CPU: the cases of ``tests/test_serve.py``, each held to the JAX package on
the same seeded workload.

Both packages warm their pools through ``compile_graph`` with no target,
and their defaults differ (``tpu_v5e(1)`` in JAX, ``gpu_sm(8)`` in the
port), so every case that compiles pins both to one target at a time
(``pinned``): the port's requests, bucket routes, KV bytes, warmup stats,
entry makespans, traces (online, static, frozen) and diagnostics must then
equal the JAX package's exactly.  The simulator is numpy and plain Python
floats in both packages, so no tolerance is needed.
"""
from __future__ import annotations

import contextlib
import copy
import json
import warnings

import pytest

import repro.verify.mutate as jax_mutate
import repro_torch.serve.bucket as port_bucket
from _pinned import TARGETS, pin
from repro import serve as jax_serve
from repro.compile.cache import ArtifactCache as JaxArtifactCache
from repro.compile.driver import clear_memo as jax_clear_memo
from repro.configs.registry import get_trace_config as jax_trace_config
from repro.verify import verify_replay as jax_verify_replay
from repro.verify import verify_serve_trace as jax_verify_serve_trace
from repro_torch.compile.cache import ArtifactCache
from repro_torch.compile.driver import clear_memo
from repro_torch.configs.registry import get_trace_config
from repro_torch.fabric.simulate import simulate_kernel_graph
from repro_torch.serve import (Admission, FifoOnlineScheduler, Request,
                               ServeParams, ServingPool, StaticBatchScheduler,
                               TracingScheduler, bucket_for, generate_requests,
                               kv_bytes, make_static_scheduler, percentile,
                               simulate_serving)
from repro_torch.verify import (DiagnosticReport, verify_placement,
                                verify_replay, verify_serve_trace,
                                verify_task_graph)
from repro_torch.verify.mutate import run_mutation

BUCKETS = (4, 8)
PARAMS = ServeParams(max_batch=4, kv_budget=1 << 15)
WORKLOAD = dict(seed=0, rate=400.0, prompt_lens=(2, 4, 6, 8),
                decode_lens=(1, 2, 3))
@contextlib.contextmanager
def pinned(target: str):
    """Both packages compile against ``target`` inside (``_pinned.pin``)."""
    with pytest.MonkeyPatch.context() as mp:
        pin(mp, target)
        yield


def jax_params():
    return jax_serve.ServeParams(**PARAMS.to_dict())


def dicts(reqs):
    return [r.to_dict() for r in reqs]


def diag_dicts(diags):
    return [d.to_dict() for d in diags]


@pytest.fixture(scope="module", params=list(TARGETS))
def target(request):
    return request.param


@pytest.fixture(scope="module")
def pools(target):
    """(port pool, JAX pool), both warmed at ``target``."""
    with pinned(target):
        port = ServingPool(archs=("olmo-1b",), buckets=BUCKETS,
                           use_cache=False)
        port.warmup()
        ref = jax_serve.ServingPool(archs=("olmo-1b",), buckets=BUCKETS,
                                    use_cache=False)
        ref.warmup()
    return port, ref


@pytest.fixture(scope="module")
def pool(pools):
    return pools[0]


@pytest.fixture(scope="module")
def requests():
    return generate_requests(12, **WORKLOAD)


@pytest.fixture(scope="module")
def jax_requests():
    return jax_serve.generate_requests(12, **WORKLOAD)


@pytest.fixture(scope="module")
def runs(pools, requests, jax_requests):
    """Each scheduler's run in both packages: name -> (port, JAX)."""
    port, ref = pools
    return {
        "online": (simulate_serving(requests, port, FifoOnlineScheduler(),
                                    PARAMS),
                   jax_serve.simulate_serving(
                       jax_requests, ref, jax_serve.FifoOnlineScheduler(),
                       jax_params())),
        "static": (simulate_serving(requests, port, StaticBatchScheduler(),
                                    PARAMS),
                   jax_serve.simulate_serving(
                       jax_requests, ref, jax_serve.StaticBatchScheduler(),
                       jax_params())),
        "frozen": (simulate_serving(
            requests, port, make_static_scheduler(FifoOnlineScheduler)(),
            PARAMS),
            jax_serve.simulate_serving(
                jax_requests, ref,
                jax_serve.make_static_scheduler(
                    jax_serve.FifoOnlineScheduler)(), jax_params())),
    }


@pytest.fixture(scope="module")
def online(runs):
    return runs["online"][0]


@pytest.fixture(scope="module")
def static(runs):
    return runs["static"][0]


@pytest.fixture(scope="module")
def frozen(runs):
    return runs["frozen"][0]


def test_public_names_equal_the_jax_packages():
    import repro_torch.serve as port_serve
    assert port_serve.__all__ == jax_serve.__all__


# -- workload -----------------------------------------------------------------

@pytest.mark.parametrize("seed,rate", [(7, 250.0), (0, 400.0)])
def test_workload_deterministic(seed, rate):
    a = generate_requests(16, seed=seed, rate=rate)
    b = generate_requests(16, seed=seed, rate=rate)
    assert dicts(a) == dicts(b)
    c = generate_requests(16, seed=seed + 1, rate=rate)
    assert dicts(a) != dicts(c)
    assert dicts(a) == dicts(jax_serve.generate_requests(16, seed=seed,
                                                         rate=rate))


@pytest.mark.parametrize("archs", [("olmo-1b",), ("olmo-1b", "qwen2-7b")])
def test_workload_poisson_shape(archs):
    reqs = generate_requests(32, seed=0, rate=100.0, archs=archs)
    arrivals = [r.arrival for r in reqs]
    assert arrivals == sorted(arrivals)
    assert all(a >= 0.0 for a in arrivals)
    assert len({r.rid for r in reqs}) == 32
    assert all(r.prompt_len > 0 and r.decode_len > 0 for r in reqs)
    assert dicts(reqs) == dicts(jax_serve.generate_requests(
        32, seed=0, rate=100.0, archs=archs))


@pytest.mark.parametrize("burst_size", [4, 8])
def test_workload_burst_groups(burst_size):
    reqs = generate_requests(16, seed=0, rate=100.0, arrival="burst",
                             burst_size=burst_size)
    starts = sorted({r.arrival for r in reqs})
    # 16 requests in bursts share exactly 16 / burst_size arrival times.
    assert len(starts) == 16 // burst_size
    for s in starts:
        assert sum(1 for r in reqs if r.arrival == s) == burst_size
    assert dicts(reqs) == dicts(jax_serve.generate_requests(
        16, seed=0, rate=100.0, arrival="burst", burst_size=burst_size))


def test_workload_rejects_what_jax_rejects():
    for kw in ({"rate": 0.0}, {"arrival": "uniform"}):
        with pytest.raises(ValueError):
            generate_requests(4, **kw)
        with pytest.raises(ValueError):
            jax_serve.generate_requests(4, **kw)
    assert generate_requests(0) == jax_serve.generate_requests(0) == []


def test_request_roundtrip():
    r = Request(rid=3, arch="olmo-1b", arrival=0.5, prompt_len=6,
                decode_len=2)
    assert Request.from_dict(r.to_dict()) == r
    assert r.tokens == 8
    assert r.to_dict() == jax_serve.Request.from_dict(r.to_dict()).to_dict()


@pytest.mark.parametrize("vals", [[4.0, 1.0, 3.0, 2.0], [2.5],
                                  [0.1, 0.7, 0.2, 0.9, 0.3]])
def test_percentile(vals):
    kept = list(vals)
    for p in (0.0, 50.0, 99.0, 100.0):
        assert percentile(vals, p) == jax_serve.percentile(vals, p)
    if vals == [4.0, 1.0, 3.0, 2.0]:
        assert percentile(vals, 0.0) == 1.0
        assert percentile(vals, 100.0) == 4.0
        assert percentile(vals, 50.0) == 2.5
    assert vals == kept                     # input untouched
    assert percentile([], 50.0) == 0.0


# -- bucket lattice -----------------------------------------------------------

@pytest.mark.parametrize("buckets", [(4, 8), (4, 8, 16), (16, 4)])
def test_bucket_for_pads_up(buckets):
    for p in range(1, max(buckets) + 1):
        assert bucket_for(p, buckets) == jax_serve.bucket_for(p, buckets)
    assert bucket_for(1, buckets) == 4
    assert bucket_for(5, buckets) == (8 if 8 in buckets else 16)
    with pytest.raises(ValueError):
        bucket_for(max(buckets) + 1, buckets)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-7b", "whisper-medium"])
def test_kv_bytes_model(arch):
    cfg = get_trace_config(arch)
    for b in (4, 8, 16):
        # bucket * K&V * kv_heads * head_dim * f32 * layers
        assert kv_bytes(cfg, b) == b * 2 * cfg.n_kv_heads * cfg.hd * 4 \
            * cfg.n_layers
        assert kv_bytes(cfg, b) == jax_serve.kv_bytes(jax_trace_config(arch),
                                                      b)


def test_warmup_dedupes_across_buckets(pools):
    pool, ref = pools
    s = pool.stats
    assert s["entries"] == len(BUCKETS)
    # kernels shared between the two bucket graphs compile once
    assert s["unique_programs"] < s["nodes"]
    assert s["fresh_compiles"] == s["unique_programs"]
    assert s["evicted"] == 0
    assert s == ref.stats
    assert {k: e.makespan for k, e in pool.entries.items()} \
        == {k: e.makespan for k, e in ref.entries.items()}
    assert {k: e.kv_bytes for k, e in pool.entries.items()} \
        == {k: e.kv_bytes for k, e in ref.entries.items()}


def test_second_arch_warms_for_free(tmp_path, target):
    # every get_trace_config arch scales to the same block dims, so the
    # second family's kernels are already in the cache: zero extra fresh.
    with pinned(target):
        clear_memo()
        one = ServingPool(archs=("olmo-1b",), buckets=BUCKETS,
                          cache=ArtifactCache(str(tmp_path / "one.json")))
        s1 = one.warmup()
        clear_memo()
        two = ServingPool(archs=("olmo-1b", "qwen2-7b"), buckets=BUCKETS,
                          cache=ArtifactCache(str(tmp_path / "two.json")))
        s2 = two.warmup()
        jax_clear_memo()
        ref = jax_serve.ServingPool(
            archs=("olmo-1b", "qwen2-7b"), buckets=BUCKETS,
            cache=JaxArtifactCache(str(tmp_path / "jax.json")))
        sj = ref.warmup()
    assert s2["entries"] == 2 * len(BUCKETS)
    assert s2["fresh_compiles"] == s1["fresh_compiles"]
    assert s2["unique_programs"] == s1["unique_programs"]
    assert s2 == sj
    assert {k: e.makespan for k, e in two.entries.items()} \
        == {k: e.makespan for k, e in ref.entries.items()}


def test_warm_restart_zero_fresh(tmp_path, target):
    path = str(tmp_path / "arts.json")
    with pinned(target):
        clear_memo()
        cold = ServingPool(archs=("olmo-1b",), buckets=BUCKETS,
                           cache=ArtifactCache(path))
        sc = cold.warmup()
        assert sc["fresh_compiles"] > 0
        clear_memo()
        warm = ServingPool(archs=("olmo-1b",), buckets=BUCKETS,
                           cache=ArtifactCache(path))
        sw = warm.warmup()
    assert sw["fresh_compiles"] == 0
    assert sw["cache_hits"] == sc["fresh_compiles"] + sc["cache_hits"]
    assert {k: e.makespan for k, e in warm.entries.items()} \
        == {k: e.makespan for k, e in cold.entries.items()}


def test_admit_corrupt_evicts_and_warns_once(pool, target):
    art = pool.get("olmo-1b", BUCKETS[0])
    corrupt = copy.deepcopy(art.cg)
    for t in list(corrupt.placement.locations):
        corrupt.placement.locations[t] = "l2"    # no legal placement
    spare = ServingPool(archs=("olmo-1b",), buckets=BUCKETS,
                        use_cache=False)
    port_bucket._warned_corrupt.discard(("olmo-1b", BUCKETS[0]))
    with pinned(target):
        with pytest.warns(UserWarning, match="evicting corrupt"):
            repaired = spare.admit(corrupt, "olmo-1b", BUCKETS[0])
        assert spare.stats.get("evicted") == 1
        rep = DiagnosticReport()
        rep.extend(verify_placement(repaired.cg.graph,
                                    repaired.cg.placement.locations,
                                    repaired.cg.placement.budget))
        assert rep.ok
        assert repaired.makespan == art.makespan
        with warnings.catch_warnings():          # second corruption: silent
            warnings.simplefilter("error")
            spare.admit(copy.deepcopy(corrupt), "olmo-1b", BUCKETS[0])
    assert spare.stats.get("evicted") == 2


def test_route(pools, requests):
    pool, ref = pools
    for r in requests:
        art = pool.route(r)
        assert art.bucket == bucket_for(r.prompt_len, BUCKETS)
        assert art.arch == r.arch
        jr = ref.route(jax_serve.Request.from_dict(r.to_dict()))
        assert (art.bucket, art.kv_bytes, art.makespan) \
            == (jr.bucket, jr.kv_bytes, jr.makespan)


# -- simulation ---------------------------------------------------------------

def test_sim_bit_deterministic(requests, pool, online):
    again = simulate_serving(requests, pool, FifoOnlineScheduler(), PARAMS)
    assert again.metrics == online.metrics
    assert again.completion_times() == online.completion_times()


@pytest.mark.parametrize("name", ["online", "static", "frozen"])
def test_trace_equals_the_jax_packages(runs, name):
    port, ref = runs[name]
    assert port.trace() == ref.trace()
    assert port.tasks == ref.tasks


def test_all_requests_complete(online, static):
    for res in (online, static):
        assert res.metrics["completed"] == res.metrics["n_requests"]
        assert res.metrics["starved"] == 0


def test_admission_respects_kv_and_batch(online):
    tr = online.trace()
    by_rid = {r["rid"]: r for r in tr["requests"]}
    for it in tr["iterations"]:
        assert len(it["running"]) <= PARAMS.max_batch
        used = sum(by_rid[r]["kv_bytes"] for r in it["running"])
        assert used <= PARAMS.kv_budget
        assert used == it["kv_used"]


def test_latency_positive_and_ordered(online):
    m = online.metrics
    assert 0.0 < m["p50_latency_s"] <= m["p99_latency_s"]
    assert m["goodput_tps"] > 0.0


def test_online_beats_static_at_high_load(pools):
    pool, ref = pools
    reqs = generate_requests(24, **{**WORKLOAD, "rate": 2000.0})
    on = simulate_serving(reqs, pool, FifoOnlineScheduler(), PARAMS)
    st = simulate_serving(reqs, pool, StaticBatchScheduler(), PARAMS)
    assert on.metrics["goodput_tps"] > st.metrics["goodput_tps"]
    assert on.metrics["makespan_s"] < st.metrics["makespan_s"]
    jreqs = jax_serve.generate_requests(24, **{**WORKLOAD, "rate": 2000.0})
    jon = jax_serve.simulate_serving(jreqs, ref,
                                     jax_serve.FifoOnlineScheduler(),
                                     jax_params())
    assert on.metrics == jon.metrics


def test_eventsim_timeline_audits_clean(online):
    assert online.tasks
    assert verify_task_graph(online.tasks) == []


def test_trace_json_roundtrip(online):
    tr = online.trace()
    assert json.loads(json.dumps(tr)) == tr
    assert tr["schema"] == 1
    assert tr["scheduler"] == "online-fifo"


# -- frozen replay ------------------------------------------------------------

def test_tracing_scheduler_records(requests, jax_requests, pools):
    pool, ref = pools
    tracer = TracingScheduler(FifoOnlineScheduler())
    simulate_serving(requests, pool, tracer, PARAMS)
    assert sorted(a.rid for a in tracer.schedules) == \
        sorted(r.rid for r in requests)
    assert all(isinstance(a, Admission) and a.wave == 0
               for a in tracer.schedules)
    jtracer = jax_serve.TracingScheduler(jax_serve.FifoOnlineScheduler())
    jax_serve.simulate_serving(jax_requests, ref, jtracer, jax_params())
    assert [tuple(a) for a in tracer.schedules] \
        == [tuple(a) for a in jtracer.schedules]
    assert tracer.name == jtracer.name


def test_frozen_replay_is_bit_identical(online, frozen):
    assert frozen.completion_times() == online.completion_times()
    assert frozen.metrics["p50_latency_s"] == online.metrics["p50_latency_s"]
    assert frozen.metrics["p99_latency_s"] == online.metrics["p99_latency_s"]
    assert frozen.scheduler == "static-online-fifo"


# -- the srv.* verifier -------------------------------------------------------

def test_verify_traces_clean(online, static, frozen):
    for res in (online, static, frozen):
        assert verify_serve_trace(res.trace()) == []
        assert jax_verify_serve_trace(res.trace()) == []


def test_verify_replay_clean_and_drift(online, frozen):
    assert verify_replay(frozen.trace(), online.trace()) == []
    drifted = frozen.trace()
    drifted["requests"][0] = dict(drifted["requests"][0])
    drifted["requests"][0]["completed"] += 1e-6
    diags = verify_replay(drifted, online.trace())
    assert any(d.rule == "srv.replay-drift" for d in diags)
    assert diag_dicts(diags) \
        == diag_dicts(jax_verify_replay(drifted, online.trace()))


def test_verify_catches_kv_violation(online):
    tr = online.trace()
    tr["params"] = dict(tr["params"], kv_budget=1)
    diags = verify_serve_trace(tr)
    assert any(d.rule == "srv.kv-budget" for d in diags)
    assert diag_dicts(diags) == diag_dicts(jax_verify_serve_trace(tr))


def test_verify_catches_starvation(online):
    tr = online.trace()
    tr["requests"][0] = dict(tr["requests"][0], admitted=None,
                             completed=None)
    rid = tr["requests"][0]["rid"]
    tr["iterations"] = [
        dict(it, running=[r for r in it["running"] if r != rid],
             admitted=[r for r in it["admitted"] if r != rid])
        for it in tr["iterations"]]
    diags = verify_serve_trace(tr)
    assert any(d.rule == "srv.starvation" for d in diags)
    assert diag_dicts(diags) == diag_dicts(jax_verify_serve_trace(tr))


@pytest.mark.parametrize("name", ["srv-over-admit", "srv-bucket-miss",
                                  "srv-replay-drift", "srv-starve"])
def test_serve_mutations_caught(name, target):
    with pinned(target):
        res = run_mutation(name)
        ref = jax_mutate.run_mutation(name)
    assert res.caught, f"{name}: expected {res.expected}, got {res.rules}"
    assert res.expected in res.rules
    assert (res.expected, res.rules) == (ref.expected, ref.rules)


# -- double-buffered overlap --------------------------------------------------

def test_double_buffer_strictly_faster(pool, target):
    cg = pool.get("olmo-1b", max(BUCKETS)).cg
    g = cg.graph
    sysgraph = TARGETS[target][0]()
    costs = {n.name: cg.kernels[cg.node_kernels[n.name]].cost
             for n in g.nodes}
    db = simulate_kernel_graph(g, costs, cg.placement.locations, sysgraph)
    ser = simulate_kernel_graph(g, costs, cg.placement.locations, sysgraph,
                                double_buffer=False)
    assert db["makespan"] < ser["makespan"]
    assert db["hbm_bytes"] == ser["hbm_bytes"]
    assert verify_task_graph(db["tasks"]) == []
    # the pool artifact's recorded makespan is the double-buffered one
    assert cg.makespan == db["makespan"]
