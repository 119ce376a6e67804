"""The port's learned cost model (paper Section 4's "machine learning to
facilitate this search problem") against the JAX package's: feature
vectors, fresh labels and ridge weights exactly equal on the same inputs,
and the same predicted GEMM block; then the behaviour tests of
``tests/test_model.py`` on the port: the store's JSON round trip and schema
guard, cache harvesting, surrogate search's guarantees, the learned tuner
backend's fallback, and ``tuned_block``'s model branch feeding K1."""
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.compile import features as jax_features
from repro.core import kernels_ir as jax_K
from repro.core import sysgraph as jax_sysgraph
from repro.search import model as jax_model
from repro.search import tune as jax_tune
from repro_torch.compile.features import (feature_dict, feature_names,
                                          feature_vector, program_family,
                                          role_extents)
from repro_torch.core import kernels_ir as K
from repro_torch.core import sysgraph
from repro_torch.core.approach import GreedyApproach
from repro_torch.core.scheduler import schedule
from repro_torch.core.sysgraph import gpu_sm, paper_accelerator, tpu_v5e
from repro_torch.kernels import gemm as gemm_mod
from repro_torch.kernels.gemm import SIMT, gemm, route_tile, tuned_block
from repro_torch.search import model as model_mod
from repro_torch.search.cache import (TuningCache, TuningRecord,
                                      set_default_cache)
from repro_torch.search.evaluate import CostModelEvaluator, LearnedEvaluator
from repro_torch.search.model import (MIN_TRAIN_SAMPLES, ModelStore,
                                      fresh_labels, harvest_cache, model_key,
                                      predict_gemm_block, set_default_store,
                                      train_family, train_suites)
from repro_torch.search.space import SearchSpace, tuning_key
from repro_torch.search.strategies import hill_climb, surrogate_search
from repro_torch.search.tune import _gemm_case, build_cases, tune_case

ROOT = Path(__file__).resolve().parent.parent
TARGETS = [("tpu_v5e", 1), ("gpu_sm", 8), ("paper_accelerator", 2)]
PROGRAMS = {
    "matmul": (lambda k: k.matmul(256, 192, 130)),
    "gru_cell": (lambda k: k.gru_cell(8, 64, 64)),
    "conv2d": (lambda k: k.conv2d(2, 8, 8, 3, 3, 8, 16)),
}
CONFIGS = [{}, {"tile_i": 256, "tile_k": None, "unroll": "red_major",
                "vmem_frac": 0.5},
           {"tile_i": "wide", "unroll": "nope", "vmem_frac": "x"},
           {"tile_j": 64, "tile_k": 128, "source": "nearest"}]
#: the fused GEMMs of ResNet-50's 1x1 layers at minibatch 28
#: (``benchmarks/bench_resnet.py``), and shapes of the tests of
#: ``tests/test_model.py``
PREDICT_SHAPES = [(512, 384, 640), (64, 64, 64), (35, 700, 2048),
                  (87808, 64, 64), (87808, 256, 64), (21952, 512, 128),
                  (5488, 1024, 256), (1372, 2048, 512)]


def graphs(target, arg):
    return getattr(sysgraph, target)(arg), getattr(jax_sysgraph, target)(arg)


def small_case():
    return _gemm_case(256, 192, 130)


def labeled(graph, n=32, seed=0):
    case = small_case()
    return case, fresh_labels(case, graph, n=n, seed=seed)


def train_store(tmp_path, graph, n=40, name="m.json"):
    """A store holding a matmul model trained on fresh labels of the small
    GEMM case."""
    case, samples = labeled(graph, n=n)
    model, _ = train_family(model_key("matmul", graph), "matmul", samples,
                            graph)
    store = ModelStore(str(tmp_path / name))
    store.store(model)
    return store


@pytest.fixture
def defaults(tmp_path):
    """An empty tuning cache as the process default; no model store is
    active after the test."""
    cache = TuningCache(str(tmp_path / "empty_tuning.json"))
    set_default_cache(cache)
    yield cache
    set_default_store(None)
    set_default_cache(None)


# --------------------------------------------------------------------------- #
# Features against the JAX package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("target,arg", TARGETS)
@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_features_match_jax_package(prog, target, arg):
    graph, jgraph = graphs(target, arg)
    p, jp = PROGRAMS[prog](K), PROGRAMS[prog](jax_K)
    names = feature_names(p, graph)
    assert names == jax_features.feature_names(jp, jgraph)
    for cfg in CONFIGS:
        d = feature_dict(cfg, p, graph)
        assert d == jax_features.feature_dict(cfg, jp, jgraph)
        assert all(np.isfinite(v) for v in d.values())
        assert tuple(d) == names
        v = feature_vector(cfg, p, graph, names)
        assert np.array_equal(v, jax_features.feature_vector(cfg, jp, jgraph,
                                                             names))
    assert program_family(p) == jax_features.program_family(jp)


def test_feature_names_identical_across_programs_and_graphs():
    """One schema for every family and machine: family models share code."""
    assert feature_names(K.matmul(64, 64, 64), tpu_v5e(1)) == \
        feature_names(K.gru_cell(4, 16, 16), paper_accelerator(2)) == \
        feature_names(K.conv2d(2, 4, 4, 3, 3, 4, 8), gpu_sm(8))


def test_program_family_strips_shapes():
    assert program_family(K.matmul(64, 64, 64)) == "matmul"
    assert program_family(K.matmul(128, 256, 512)) == "matmul"
    assert program_family("gru_cell_16x256") == "gru_cell"
    assert program_family("conv2d") == "conv2d"
    for name in ("gru_cell_16x256", "conv2d+duax+fuse_yx+fuse_byx",
                 "matmul_64x64x64"):
        assert program_family(name) == jax_features.program_family(name)


@pytest.mark.parametrize("suite", ["gemm", "conv", "gru"])
def test_role_extents_match_jax_package(suite):
    for case, jcase in zip(build_cases(suite), jax_tune.build_cases(suite)):
        roles = role_extents(case.selection)
        assert roles == jax_features.role_extents(jcase.selection)
        assert set(roles) == {"i", "j", "k"} and all(v > 0 for v in
                                                     roles.values())


def test_role_extents_from_conv_selection_bind_tile_caps():
    """Conv extractions map the MXU roles onto fused axes; tile-cap
    features bind against those extents, not against axis-name guesses."""
    case = next(c for c in build_cases("conv") if c.name.startswith("conv3x3"))
    roles = role_extents(case.selection)
    d_free = feature_dict({"tile_j": 4096}, case.program, tpu_v5e(1),
                          roles=roles)
    d_bind = feature_dict({"tile_j": 128}, case.program, tpu_v5e(1),
                          roles={**roles, "j": 4096})
    assert d_free["tile_j_binds"] == 0.0
    assert d_bind["tile_j_binds"] == 1.0
    assert d_bind["tile_j_excess"] > 0.0


def test_config_features_tolerate_junk_configs():
    d = feature_dict({"tile_i": "wide", "unroll": "nope", "vmem_frac": "x"},
                     K.matmul(64, 64, 64), tpu_v5e(1))
    assert d == feature_dict({}, K.matmul(64, 64, 64), tpu_v5e(1))


# --------------------------------------------------------------------------- #
# Labels and training against the JAX package
# --------------------------------------------------------------------------- #


def as_rows(samples):
    return [(sorted(s.config.items(), key=str), s.cost, s.case, s.source,
             s.roles, s.program.signature()) for s in samples]


@pytest.mark.parametrize("target,arg", TARGETS[:2])
@pytest.mark.parametrize("case_name", ["gemm_256x192x130", "conv1x1", "gru"])
def test_fresh_labels_match_jax_package(case_name, target, arg):
    graph, jgraph = graphs(target, arg)
    if case_name.startswith("gemm"):
        case, jcase = small_case(), jax_tune._gemm_case(256, 192, 130)
    else:
        suite = "gru" if case_name == "gru" else "conv"
        case = next(c for c in build_cases(suite) if
                    c.name.startswith(case_name))
        jcase = next(c for c in jax_tune.build_cases(suite)
                     if c.name == case.name)
    got = fresh_labels(case, graph, n=24, seed=3)
    want = jax_model.fresh_labels(jcase, jgraph, n=24, seed=3)
    assert len(got) >= MIN_TRAIN_SAMPLES
    assert as_rows(got) == as_rows(want)
    assert as_rows(got) == as_rows(fresh_labels(case, graph, n=24, seed=3))


@pytest.mark.parametrize("target,arg", TARGETS[:2])
def test_train_family_matches_jax_package(target, arg):
    """Both sides run the same numpy: names, scaler, weights, intercept,
    anchors and holdout metrics are bit-equal; only the key's toolchain
    differs."""
    graph, jgraph = graphs(target, arg)
    samples = fresh_labels(small_case(), graph, n=40, seed=0)
    jsamples = jax_model.fresh_labels(jax_tune._gemm_case(256, 192, 130),
                                      jgraph, n=40, seed=0)
    got, met = train_family(model_key("matmul", graph), "matmul", samples,
                            graph, seed=7)
    want, jmet = jax_model.train_family(jax_model.model_key("matmul", jgraph),
                                        "matmul", jsamples, jgraph, seed=7)
    assert got.names == want.names
    for f in ("weights", "x_mean", "x_scale"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.intercept, got.alpha, got.n_samples, got.meta) == \
        (want.intercept, want.alpha, want.n_samples, want.meta)
    assert {k: v for k, v in met.items() if k != "key"} == \
        {k: v for k, v in jmet.items() if k != "key"}
    assert got.key.rpartition("|")[0] == want.key.rpartition("|")[0]
    assert got.key.endswith(f"|torch={torch.__version__}")
    d = got.to_dict()
    assert {k: v for k, v in d.items() if k != "key"} == \
        {k: v for k, v in want.to_dict().items() if k != "key"}


def test_train_predict_deterministic():
    case, samples = labeled(tpu_v5e(1))
    graph = tpu_v5e(1)
    key = model_key("matmul", graph)
    m1, met1 = train_family(key, "matmul", samples, graph, seed=7)
    m2, met2 = train_family(key, "matmul", samples, graph, seed=7)
    assert np.array_equal(m1.weights, m2.weights)
    assert met1 == met2
    cfg = {"tile_i": 256}
    assert m1.predict(cfg, case.program, graph) == \
        m2.predict(cfg, case.program, graph)


def test_model_json_roundtrip(tmp_path):
    case, samples = labeled(tpu_v5e(1))
    graph = tpu_v5e(1)
    model, _ = train_family(model_key("matmul", graph), "matmul", samples,
                            graph)
    path = str(tmp_path / "models.json")
    ModelStore(path).store(model)
    loaded = ModelStore(path).lookup(model.key)     # fresh instance, re-read
    assert loaded is not None and loaded.names == model.names
    space = SearchSpace.for_graph(graph)
    rng = random.Random(0)
    for _ in range(10):
        cfg = space.random_config(rng)
        assert loaded.predict(cfg, case.program, graph) == \
            model.predict(cfg, case.program, graph)


def test_train_refuses_insufficient_samples():
    _, samples = labeled(tpu_v5e(1), n=8)
    graph = tpu_v5e(1)
    model, metrics = train_family(model_key("matmul", graph), "matmul",
                                  samples[:MIN_TRAIN_SAMPLES - 1], graph)
    assert model is None
    assert metrics["trained"] is False
    assert "required" in metrics["reason"]


def test_store_skips_schema_drifted_models(tmp_path):
    store = train_store(tmp_path, tpu_v5e(1))
    key = next(iter(store.load()))
    raw = json.loads(Path(store.path).read_text())
    raw["models"][0]["feature_schema"] = 999
    Path(store.path).write_text(json.dumps(raw))
    assert ModelStore(store.path).lookup(key) is None   # drift => no model


def test_store_default_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(model_mod.MODEL_ENV_VAR, raising=False)
    assert model_mod.default_store_path().endswith(
        os.path.join(".cache", "repro_torch", "models.json"))
    assert model_mod.MODEL_ENV_VAR == "REPRO_TORCH_MODEL_STORE"
    monkeypatch.setenv("REPRO_TORCH_MODEL_STORE", str(tmp_path / "m.json"))
    assert ModelStore().path == str(tmp_path / "m.json")
    from repro_torch import search
    assert search.ModelStore is ModelStore


def test_harvest_cache_yields_winner_and_baseline(tmp_path):
    case = small_case()
    graph = tpu_v5e(1)
    o = hill_climb(SearchSpace.for_graph(graph),
                   CostModelEvaluator(case.selection, graph), trials=8,
                   seed=0)
    cache = TuningCache(str(tmp_path / "t.json"))
    cache.store(TuningRecord(
        key=tuning_key(case.program, graph, "cost"), config=o.best_config,
        cost=o.best_cost, baseline_cost=o.baseline_cost))
    samples = harvest_cache(cache, [case], graph)
    assert len(samples) == 2
    assert all(s.source == "cache" for s in samples)
    assert {s.cost for s in samples} == {o.best_cost, o.baseline_cost}


# --------------------------------------------------------------------------- #
# Surrogate search: anchoring and fallback
# --------------------------------------------------------------------------- #


def trained_evaluator(case, graph, tmp_path):
    samples = fresh_labels(case, graph, n=40, seed=0)
    family = program_family(case.program)
    model, _ = train_family(model_key(family, graph), family, samples, graph)
    store = ModelStore(str(tmp_path / "m.json"))
    store.store(model)
    return LearnedEvaluator.for_selection(case.selection, graph, store=store)


@pytest.mark.parametrize("target,arg", TARGETS[:2])
def test_surrogate_never_worse_than_greedy(tmp_path, target, arg):
    case, graph = small_case(), getattr(sysgraph, target)(arg)
    space = SearchSpace.for_graph(graph)
    ev = CostModelEvaluator(case.selection, graph)
    greedy = schedule(case.selection, graph, GreedyApproach()).makespan
    le = trained_evaluator(case, graph, tmp_path)
    o = surrogate_search(space, ev, trials=10, seed=0, predict=le.predictor)
    assert o.trials[0].config == space.baseline()     # baseline first
    assert o.baseline_cost == greedy
    assert o.best_cost <= greedy
    assert o.strategy == "surrogate"


def test_surrogate_deterministic_under_fixed_seed(tmp_path):
    case, graph = small_case(), tpu_v5e(1)
    space = SearchSpace.for_graph(graph)
    ev = CostModelEvaluator(case.selection, graph)
    le = trained_evaluator(case, graph, tmp_path)
    o1 = surrogate_search(space, ev, trials=12, seed=5, predict=le.predictor)
    o2 = surrogate_search(space, ev, trials=12, seed=5, predict=le.predictor)
    assert [(sorted(t.config.items(), key=str), t.cost) for t in o1.trials] \
        == [(sorted(t.config.items(), key=str), t.cost) for t in o2.trials]


def test_surrogate_matches_hillclimb_at_half_budget(tmp_path):
    """Trained and anchored, the surrogate reaches hill-climb's best with
    half the real evaluations."""
    case, graph = small_case(), tpu_v5e(1)
    space = SearchSpace.for_graph(graph)
    ev = CostModelEvaluator(case.selection, graph)
    hc = hill_climb(space, ev, trials=16, seed=0)
    cache = TuningCache(str(tmp_path / "t.json"))
    cache.store(TuningRecord(
        key=tuning_key(case.program, graph, "cost"), config=hc.best_config,
        cost=hc.best_cost, baseline_cost=hc.baseline_cost))
    samples = harvest_cache(cache, [case], graph)
    samples += fresh_labels(case, graph, n=40, seed=0,
                            anchors=[hc.best_config])
    model, _ = train_family(model_key("matmul", graph), "matmul", samples,
                            graph)
    sg = surrogate_search(space, ev, trials=8, seed=0,
                          predict=model.predictor(case.program, graph),
                          seeds=list(model.meta["anchors"])
                          or [hc.best_config])
    assert sg.best_cost <= hc.best_cost
    assert sg.evaluations <= hc.evaluations // 2


def test_surrogate_without_model_falls_back_to_hillclimb():
    case, graph = small_case(), tpu_v5e(1)
    space = SearchSpace.for_graph(graph)
    ev = CostModelEvaluator(case.selection, graph)
    o = surrogate_search(space, ev, trials=10, seed=0, predict=None)
    hc = hill_climb(space, ev, trials=10, seed=0)
    assert o.strategy == "surrogate:fallback-hillclimb"
    assert o.best_cost == hc.best_cost
    assert [t.cost for t in o.trials] == [t.cost for t in hc.trials]


def test_learned_evaluator_none_without_store_or_model(tmp_path, defaults):
    case, graph = small_case(), gpu_sm(8)
    assert LearnedEvaluator.for_selection(case.selection, graph,
                                          store=None) is None
    empty = ModelStore(str(tmp_path / "empty.json"))
    assert LearnedEvaluator.for_selection(case.selection, graph,
                                          store=empty) is None
    # a model for another graph is no model for this one
    other = train_store(tmp_path, tpu_v5e(1), name="v5e.json")
    assert LearnedEvaluator.for_selection(case.selection, graph,
                                          store=other) is None


def test_learned_evaluator_scores_match_jax_package(tmp_path):
    """Guarded pool scores equal JAX's bit for bit; one config at a time
    they agree to float64 rounding (a batched product sums in another
    order)."""
    case, graph = small_case(), gpu_sm(8)
    le = LearnedEvaluator.for_selection(case.selection, graph,
                                        store=train_store(tmp_path, graph))
    jcase, jgraph = jax_tune._gemm_case(256, 192, 130), jax_sysgraph.gpu_sm(8)
    jsamples = jax_model.fresh_labels(jcase, jgraph, n=40, seed=0)
    jmodel, _ = jax_model.train_family(jax_model.model_key("matmul", jgraph),
                                       "matmul", jsamples, jgraph)
    jstore = jax_model.ModelStore(str(tmp_path / "jax_models.json"))
    jstore.store(jmodel)
    from repro.search.evaluate import LearnedEvaluator as JaxLearnedEvaluator
    jle = JaxLearnedEvaluator.for_selection(jcase.selection, jgraph,
                                            store=jstore)
    space = SearchSpace.for_graph(graph)
    configs = [space.baseline()] + list(space.neighbors(space.baseline()))
    configs += [space.random_config(random.Random(i)) for i in range(16)]
    scores = le.predict_many(configs)
    assert scores == jle.predict_many(configs)
    assert scores == pytest.approx([le(c) for c in configs], rel=1e-12)
    assert le.stats.evals == 2 * len(configs)
    assert le.stats.guard_rejects == jle.stats.guard_rejects
    assert all(s > 0 for s in scores)


def test_tune_case_learned_backend_degrades_to_cost(tmp_path):
    """--backend learned with no trained model behaves as the cost backend
    (and still tunes to no worse than greedy)."""
    case, graph = small_case(), gpu_sm(8)
    rep = tune_case(case, graph, "hillclimb", 6, 0, "learned",
                    validate=False,
                    model_store=ModelStore(str(tmp_path / "none.json")))
    want = tune_case(case, graph, "hillclimb", 6, 0, "cost", validate=False)
    assert rep.backend == "cost"
    assert rep.tuned_cost <= rep.greedy_cost
    assert (rep.config, rep.tuned_cost, rep.outcome.strategy) == \
        (want.config, want.tuned_cost, "hillclimb")


def test_tune_case_learned_backend_runs_the_surrogate(tmp_path):
    case, graph = small_case(), gpu_sm(8)
    store = train_store(tmp_path, graph)
    rep = tune_case(case, graph, "hillclimb", 6, 0, "learned",
                    validate=True, model_store=store, strategy_explicit=False)
    assert rep.backend == "cost"
    assert rep.outcome.strategy == "surrogate"
    assert rep.tuned_cost <= rep.greedy_cost and rep.validation.exact
    assert rep.counters["predict_s"] > 0


def test_train_suites_trains_and_stores(tmp_path):
    graph = gpu_sm(8)
    cache = TuningCache(str(tmp_path / "t.json"))     # empty: fresh only
    store = ModelStore(str(tmp_path / "m.json"))
    rows = train_suites("conv", graph, cache, store, samples_per_case=20,
                        seed=0)
    jrows = jax_model.train_suites(
        "conv", jax_sysgraph.gpu_sm(8),
        jax_model.TuningCache(str(tmp_path / "jt.json")),
        jax_model.ModelStore(str(tmp_path / "jm.json")), samples_per_case=20,
        seed=0)
    trained = [r for r in rows if r["trained"]]
    assert trained and all("train_mae_log" in r for r in trained)
    assert len(store) == len(trained)
    assert [{k: v for k, v in r.items() if k != "key"} for r in rows] == \
        [{k: v for k, v in r.items() if k != "key"} for r in jrows]


# --------------------------------------------------------------------------- #
# The predicted block, and K1 at it
# --------------------------------------------------------------------------- #


def test_predict_gemm_block_requires_store(defaults):
    assert predict_gemm_block(64, 64, 64, store=None) is None
    assert predict_gemm_block(64, 64, 64) is None          # none active


@pytest.mark.parametrize("target,arg", TARGETS[:2])
def test_predict_gemm_block_matches_jax_package(tmp_path, target, arg):
    """Models trained on the same labels pick the same block, at the test
    shapes and at ResNet-50's extracted 1x1 GEMMs."""
    graph, jgraph = graphs(target, arg)
    store = train_store(tmp_path, graph)
    jsamples = jax_model.fresh_labels(jax_tune._gemm_case(256, 192, 130),
                                      jgraph, n=40, seed=0)
    jmodel, _ = jax_model.train_family(jax_model.model_key("matmul", jgraph),
                                       "matmul", jsamples, jgraph)
    jstore = jax_model.ModelStore(str(tmp_path / "jax_models.json"))
    jstore.store(jmodel)
    for m, n, k in PREDICT_SHAPES:
        got = predict_gemm_block(m, n, k, store=store, graph=graph)
        assert got is not None
        assert got == jax_model.predict_gemm_block(m, n, k, store=jstore,
                                                   graph=jgraph)
        assert all(1 <= t <= d for t, d in zip(got, (m, n, k)))


def test_predict_gemm_block_defaults_to_the_modeled_gpu(tmp_path, defaults):
    store = train_store(tmp_path, gpu_sm(8))
    set_default_store(store)
    assert predict_gemm_block(21952, 512, 128) == predict_gemm_block(
        21952, 512, 128, store=store, graph=gpu_sm(8))
    # a store with only a v5e model has nothing for the default graph
    set_default_store(train_store(tmp_path, tpu_v5e(1), name="v5e.json"))
    assert predict_gemm_block(21952, 512, 128) is None


@pytest.fixture
def tile_spy(monkeypatch):
    """Records every tile the GEMM wrappers check."""
    seen = []
    check = gemm_mod._check_tile

    def spy(tile, route):
        seen.append(tuple(tile))
        return check(tile, route)
    monkeypatch.setattr(gemm_mod, "_check_tile", spy)
    return seen


def test_tuned_block_uses_model_on_cache_miss(tmp_path, defaults, tile_spy):
    m, n, k = 512, 384, 640
    store = train_store(tmp_path, gpu_sm(8))
    assert tuned_block(m, n, k) is None                 # no store: a miss
    set_default_store(store)
    block = tuned_block(m, n, k)
    assert block == predict_gemm_block(m, n, k, store=store)
    assert block is not None and all(1 <= t <= d
                                     for t, d in zip(block, (m, n, k)))
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(-1, 1, (m, k)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, (k, n)).astype(np.float32))
    tile_spy.clear()
    torch.testing.assert_close(gemm(a, b), a @ b)
    assert tile_spy == [route_tile(block, SIMT)]
    # a tuning record still comes first
    defaults.store(TuningRecord(
        key=tuning_key(K.matmul(m, n, k), gpu_sm(8), "cost"),
        config={}, cost=1e-5, baseline_cost=2e-5, tile=(64, 64, 64)))
    assert tuned_block(m, n, k) == (64, 64, 64)


def test_tuned_block_survives_an_unreadable_store(tmp_path, defaults):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    set_default_store(ModelStore(str(bad)))
    with pytest.warns(UserWarning, match="corrupt"):
        assert tuned_block(512, 384, 640) is None


# --------------------------------------------------------------------------- #
# The CLI, as a user runs it
# --------------------------------------------------------------------------- #


def run(tmp_path, module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path)


def test_model_cli_train_eval_export_roundtrip(tmp_path):
    cache, store = tmp_path / "cache.json", tmp_path / "models.json"
    res = run(tmp_path, "repro_torch.search.tune", "--suite", "gemm",
              "--limit", "1", "--trials", "6", "--cache", str(cache),
              "--no-validate")
    assert res.returncode == 0, res.stdout + res.stderr
    res = run(tmp_path, "repro_torch.search.model", "train", "--suite",
              "gemm", "--target", "gpu_sm", "--cache", str(cache), "--store",
              str(store), "--samples", "20", "--json",
              str(tmp_path / "train.json"))
    assert res.returncode == 0, res.stdout + res.stderr
    rows = json.loads((tmp_path / "train.json").read_text())["rows"]
    assert [r["family"] for r in rows if r["trained"]] == ["matmul"]
    assert rows[0]["sources"]["cache"] == 2            # winner + baseline
    models = json.loads(store.read_text())["models"]
    assert [m["key"].split("|")[1].split("@")[0] for m in models] == \
        ["gpu_sm_x8"]

    res = run(tmp_path, "repro_torch.search.model", "eval", "--suite",
              "gemm", "--store", str(store), "--samples", "12", "--topk",
              "4", "--json", str(tmp_path / "eval.json"))
    assert res.returncode == 0, res.stdout + res.stderr
    ev = json.loads((tmp_path / "eval.json").read_text())
    assert ev["worst_regret"] is not None and ev["worst_regret"] >= 1.0

    res = run(tmp_path, "repro_torch.search.model", "export", "--store",
              str(store), "--key", models[0]["key"], "--out",
              str(tmp_path / "one.json"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert json.loads((tmp_path / "one.json").read_text()) == models[0]

    res = run(tmp_path, "repro_torch.search.tune", "--suite", "gemm",
              "--limit", "1", "--trials", "4", "--backend", "learned",
              "--model", str(store), "--cache", str(tmp_path / "c2.json"),
              "--no-validate", "--json", str(tmp_path / "r2.json"))
    assert res.returncode == 0, res.stdout + res.stderr
    row = json.loads((tmp_path / "r2.json").read_text())["rows"][0]
    assert row["strategy"] == "surrogate" and row["backend"] == "cost"
    assert row["tuned_cost_s"] <= row["greedy_cost_s"]


def test_tune_cli_learned_backend_refuses_the_fabric_suite(tmp_path):
    res = run(tmp_path, "repro_torch.search.tune", "--suite", "fabric",
              "--backend", "learned", "--cache", str(tmp_path / "c.json"))
    assert res.returncode == 2
    assert "not supported for --suite fabric" in res.stderr
    assert not (tmp_path / "c.json").exists()
