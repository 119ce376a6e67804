"""The port's search tier against the JAX package's, on ``gpu_sm(8)``: the
tuning key, cost-backend tuning (same best config, costs and record block),
the executor the oracle validation replays through, the tuning cache, and
the kernels' cache lookups (``plan_gemm``, ``tuned_block``,
``gemm(tile=None)``).  The measured backend needs the card: here it must
refuse to run."""
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compile import compile_selection as jax_compile_selection
from repro.core import kernels_ir as jax_K
from repro.core.executor import execute as jax_execute
from repro.core.ir import random_inputs as jax_random_inputs
from repro.core.sysgraph import gpu_sm as jax_gpu_sm
from repro.kernels.gemm import gemm_bias_act as jax_gemm_bias_act
from repro.search import tune as jax_tune
from repro.search.evaluate import CostModelEvaluator as JaxCostModelEvaluator
from repro.search.space import ParamApproach as JaxParamApproach
from repro.search.space import tuning_key as jax_tuning_key
from repro_torch.compile import compile_selection
from repro_torch.core import kernels_ir as K
from repro_torch.core.executor import execute
from repro_torch.core.ir import random_inputs
from repro_torch.core.sysgraph import gpu_sm
from repro_torch.kernels import gemm as gemm_mod
from repro_torch.kernels.gemm import (SIMT, block_tile, gemm,
                                      gemm_bias_act, tuned_block)
from repro_torch.kernels.ops import plan_gemm
from repro_torch.search import cache as cache_mod
from repro_torch.search import tune
from repro_torch.search.cache import (TuningCache, TuningRecord,
                                      gemm_tuning_key, lookup_gemm,
                                      set_default_cache)
from repro_torch.search.evaluate import (CostModelEvaluator,
                                         MeasuredGemmEvaluator)
from repro_torch.search.space import ParamApproach, SearchSpace, tuning_key

ROOT = Path(__file__).resolve().parent.parent
TUNE_CASES = {
    "gemm_1024x128x1024": (tune._gemm_case, jax_tune._gemm_case,
                           (1024, 128, 1024)),
    "gemm_35x700x2048": (tune._gemm_case, jax_tune._gemm_case,
                         (35, 700, 2048)),
    "gru_16x256": (tune._gru_case, jax_tune._gru_case, (16, 256)),
}


@pytest.fixture
def default_cache(tmp_path):
    """A fresh tuning cache as the process default, restored afterwards."""
    cache = TuningCache(str(tmp_path / "tuning.json"))
    set_default_cache(cache)
    yield cache
    set_default_cache(None)


def strip_version(key: str) -> str:
    head, _, version = key.rpartition("|")
    assert version.split("=")[0] in ("jax", "torch"), key
    return head


# --------------------------------------------------------------------------- #
# Keys and cost-backend tuning against the JAX package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("m,n,k", tune.DEEPBENCH_GEMM_SIZES)
def test_tuning_key_matches_jax_up_to_the_version(m, n, k):
    for backend in ("cost", "measure"):
        port = tuning_key(K.matmul(m, n, k), gpu_sm(8), backend)
        ref = jax_tuning_key(jax_K.matmul(m, n, k), jax_gpu_sm(8), backend)
        assert port.endswith(f"|{backend}|torch={torch.__version__}")
        assert strip_version(port) == strip_version(ref)
        assert gemm_tuning_key(m, n, k, backend=backend) == port


@pytest.mark.parametrize("strategy", ["hillclimb", "random"])
@pytest.mark.parametrize("name", list(TUNE_CASES))
def test_cost_tuning_matches_jax(name, strategy):
    port_case, jax_case, args = TUNE_CASES[name]
    pcase, jcase = port_case(*args), jax_case(*args)
    graph, jgraph = gpu_sm(8), jax_gpu_sm(8)
    got = tune.tune_case(pcase, graph, strategy, trials=8, seed=0,
                         backend="cost")
    want = jax_tune.tune_case(jcase, jgraph, strategy, trials=8, seed=0,
                              backend="cost")
    assert got.config == want.config
    assert got.greedy_cost == want.greedy_cost
    assert got.tuned_cost == want.tuned_cost
    assert got.backend == want.backend == "cost"
    assert strip_version(got.key) == strip_version(want.key)
    assert got.validation.exact and want.validation.exact
    rec = tune.record_for(pcase, got, graph, strategy)
    jrec = jax_tune.record_for(jcase, want, jgraph, strategy)
    assert rec.tile == jrec.tile
    assert (rec.cost, rec.baseline_cost) == (jrec.cost, jrec.baseline_cost)
    if pcase.gemm_shape is None:
        assert rec.tile is None
    else:
        assert rec.tile is not None and got.tuned_cost <= got.greedy_cost


@pytest.mark.parametrize("which", ["gemm", "gru"])
def test_population_scores_match_jax_and_the_scalar_path(which):
    """``evaluate_many`` (batch guard, schedule-key memo, DeltaScheduler)
    scores exactly as the scalar path and as the JAX package."""
    if which == "gemm":
        pcase, jcase = tune._gemm_case(256, 192, 130), \
            jax_tune._gemm_case(256, 192, 130)
    else:
        pcase, jcase = tune._gru_case(4, 64), jax_tune._gru_case(4, 64)
    graph = gpu_sm(8)
    space = SearchSpace.for_graph(graph)
    configs = list(space.enumerate_configs())
    configs = [configs[i] for i in
               random.Random(0).sample(range(len(configs)), 32)]
    batch = CostModelEvaluator(pcase.selection, graph)
    scores = batch.evaluate_many(configs)
    scalar = CostModelEvaluator(pcase.selection, graph)
    assert scores == [scalar(c) for c in configs]
    assert batch.stats.fresh + batch.stats.delta > 0
    jax_scores = JaxCostModelEvaluator(jcase.selection,
                                       jax_gpu_sm(8)).evaluate_many(configs)
    assert scores == jax_scores


@pytest.mark.parametrize("which", ["gemm", "gru"])
def test_executor_matches_jax(which):
    if which == "gemm":
        pcase, jcase = tune._gemm_case(40, 24, 56), \
            jax_tune._gemm_case(40, 24, 56)
    else:
        pcase, jcase = tune._gru_case(4, 16), jax_tune._gru_case(4, 16)
    config = {"tile_i": 256, "tile_k": 32, "unroll": "red_major"}
    sched = compile_selection(pcase.proxy_selection, gpu_sm(8),
                              ParamApproach(config)).schedule
    jsched = jax_compile_selection(jcase.proxy_selection, jax_gpu_sm(8),
                                   JaxParamApproach(config)).schedule
    ins = random_inputs(pcase.proxy_original, np.random.default_rng(3))
    jins = jax_random_inputs(jcase.proxy_original, np.random.default_rng(3))
    got = execute(sched, pcase.proxy_selection, ins)
    want = jax_execute(jsched, jcase.proxy_selection, jins)
    assert set(got) == set(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name


# --------------------------------------------------------------------------- #
# The tuning cache
# --------------------------------------------------------------------------- #


def test_cache_round_trip(tmp_path):
    path = str(tmp_path / "t.json")
    rec = TuningRecord(key="k", config={"tile_i": 256}, cost=1.5,
                       baseline_cost=2.0, backend="measure", strategy="hc",
                       trials=8, tile=(512, 64, 483),
                       meta={"device": "card", "measured_s": 1e-4})
    TuningCache(path).store(rec)
    back = TuningCache(path).lookup("k")
    assert back.to_dict() == rec.to_dict()
    assert back.tile == (512, 64, 483) and back.speedup == 2.0 / 1.5


def test_cache_default_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(cache_mod.CACHE_ENV_VAR, raising=False)
    assert cache_mod.default_cache_path().endswith(
        os.path.join(".cache", "repro_torch", "tuning.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "x.json"))
    assert cache_mod.default_cache_path() == str(tmp_path / "x.json")


def test_lookup_gemm_prefers_measured(default_cache):
    default_cache.store(TuningRecord(
        key=gemm_tuning_key(64, 64, 64, backend="cost"), config={},
        cost=2.0, baseline_cost=2.0, backend="cost", tile=(128, 128, 128)),
        save=False)
    default_cache.store(TuningRecord(
        key=gemm_tuning_key(64, 64, 64, backend="measure"), config={},
        cost=1.0, baseline_cost=2.0, backend="measure", tile=(64, 64, 64)))
    rec = lookup_gemm(64, 64, 64)
    assert rec is not None and rec.backend == "measure"
    assert lookup_gemm(65, 64, 64) is None


def test_cache_tolerates_corrupt_file(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text("{not json")
    c = TuningCache(str(path))
    with pytest.warns(UserWarning, match="corrupt"):
        assert len(c) == 0
    c.store(TuningRecord(key="k", config={}, cost=1.0, baseline_cost=1.0))
    assert TuningCache(str(path)).lookup("k") is not None


# --------------------------------------------------------------------------- #
# The kernels read the cache
# --------------------------------------------------------------------------- #


@pytest.fixture
def tile_spy(monkeypatch):
    """Records every tile the GEMM wrappers check, the tuned one too."""
    seen = []
    check = gemm_mod._check_tile

    def spy(tile, route):
        seen.append(tuple(tile))
        return check(tile, route)
    monkeypatch.setattr(gemm_mod, "_check_tile", spy)
    return seen


def test_kernels_take_the_cached_block(default_cache, tile_spy):
    m, n, k = 2048, 64, 2048
    block = (512, 64, 483)
    tile = block_tile(block)
    assert tile == (128, 16, 32)
    default_cache.store(TuningRecord(
        key=gemm_tuning_key(m, n, k, backend="measure"), config={},
        cost=3e-5, baseline_cost=6e-5, backend="measure", tile=block))
    assert tuned_block(m, n, k) == block
    cfg, cost = plan_gemm(m, n, k)
    assert (cfg.block, cfg.tile, cost) == (block, tile, 3e-5)
    assert cfg.grid == (-(-m // 128), -(-n // 16))
    greedy, _ = plan_gemm(m, n, k, use_cache=False)
    assert greedy.block == (256, 64, 921) and greedy.tile != tile
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(-1, 1, (m, k)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, (k, n)).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, (n,)).astype(np.float32))
    tile_spy.clear()
    torch.testing.assert_close(gemm(a, b), a @ b)
    torch.testing.assert_close(gemm_bias_act(a, b, bias, "relu"),
                               torch.relu(a @ b + bias))
    assert tile_spy == [tile, tile]
    # a shape with no record: the compiler's block / the default tile
    tile_spy.clear()
    assert tuned_block(m + 1, n, k) is None
    gemm(a[:7], b)
    assert tile_spy == [SIMT.default_tile]


def test_tuned_slice_matches_jax_package(default_cache, tmp_path):
    """Tune (cost backend) into the port's cache, then the fused instruction
    at the tuned block against the Pallas kernel at the same block."""
    m, n, k = 1024, 128, 1024
    assert tune.main(["--suite", "gemm", "--limit", "1", "--trials", "8",
                      "--cache", default_cache.path]) == 0
    default_cache._entries = None                 # re-read what tune wrote
    block = tuned_block(m, n, k)
    jcase = jax_tune._gemm_case(m, n, k)
    want_rep = jax_tune.tune_case(jcase, jax_gpu_sm(8), "hillclimb", 8, 0,
                                  "cost")
    assert block == jax_tune.record_for(jcase, want_rep, jax_gpu_sm(8),
                                        "hillclimb").tile
    rng = np.random.default_rng(7)
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    bias = rng.uniform(-1, 1, (n,)).astype(np.float32)
    got = gemm_bias_act(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(bias), "tanh")
    want = jax_gemm_bias_act(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(bias), fn="tanh", block=block,
                             interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------- #
# The CLI and the measured backend
# --------------------------------------------------------------------------- #


def run_tune(tmp_path, *args, env=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env or {}))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.search.tune", "--suite", "gemm",
         "--limit", "2", "--trials", "4", "--cache",
         str(tmp_path / "tuning.json"), *args],
        env=env, capture_output=True, text=True, timeout=600, cwd=tmp_path)


@pytest.mark.parametrize("workers", [1, 2])
def test_tune_cli_cost_backend(tmp_path, workers):
    out = run_tune(tmp_path, "--backend", "cost", "--workers", str(workers),
                   "--json", str(tmp_path / "report.json"))
    assert out.returncode == 0, out.stderr
    records = json.loads((tmp_path / "tuning.json").read_text())["records"]
    assert len(records) == 2
    assert all(r["backend"] == "cost" and len(r["tile"]) == 3
               for r in records)
    rows = json.loads((tmp_path / "report.json").read_text())["rows"]
    assert [r["exact"] for r in rows] == [True, True]
    # the records are the in-process tuner's, whatever the worker count
    for rec in records:
        case = tune._gemm_case(*map(int, rec["meta"]["case"][5:].split("x")))
        rep = tune.tune_case(case, gpu_sm(8), "hillclimb", 4, 0, "cost")
        assert (rec["config"], tuple(rec["tile"]), rec["cost"]) == (
            rep.config, tune.record_for(case, rep, gpu_sm(8),
                                        "hillclimb").tile, rep.tuned_cost)


def test_tune_cli_measure_without_a_card_fails_and_writes_nothing(tmp_path):
    out = run_tune(tmp_path, "--backend", "measure",
                   env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not (tmp_path / "tuning.json").exists()


def test_measured_evaluator_needs_a_cuda_device(monkeypatch):
    with pytest.raises(ValueError, match="CUDA"):
        MeasuredGemmEvaluator(64, 64, 64, gpu_sm(8), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeasuredGemmEvaluator(64, 64, 64, gpu_sm(8))


class FakeMeasured:
    """Stands in for the card: a score per CUDA tile."""

    def __init__(self, m, n, k, graph, seed=0, score=None):
        self.m, self.n, self.k, self.graph = m, n, k, graph
        self.device = "cuda:0"
        self.score = score

    block_for = MeasuredGemmEvaluator.block_for
    tile_for = MeasuredGemmEvaluator.tile_for

    def __call__(self, config):
        bm, bn, bk = self.tile_for(config)
        return self.score if self.score is not None else 1e-3 / (bm * bn)


def test_measured_tuning_records_the_card(monkeypatch):
    monkeypatch.setattr(tune, "MeasuredGemmEvaluator", FakeMeasured)
    monkeypatch.setattr(tune, "_card", lambda ev: {
        "device": "card", "torch": torch.__version__, "cuda": None})
    case = tune._gemm_case(1024, 128, 1024)
    rep = tune.tune_case(case, gpu_sm(8), "hillclimb", 8, 0, "measure")
    assert rep.backend == "measure" and rep.key.endswith(
        f"|measure|torch={torch.__version__}")
    assert rep.tuned_cost <= rep.greedy_cost and rep.validation.exact
    rec = tune.record_for(case, rep, gpu_sm(8), "hillclimb")
    assert rec.meta["device"] == "card"
    assert rec.meta["torch"] == torch.__version__
    assert rec.meta["measured_s"] > 0 and rec.tile is not None
    tiles = rec.meta["tiles_s"]
    assert "64x32x32" in tiles and len(tiles) > 1     # the plan's tile and more
    assert rec.meta["measured_s"] in tiles.values()
    # the GRU suite has no measured kernel: it stays on the cost backend
    gru = tune.tune_case(tune._gru_case(16, 256), gpu_sm(8), "hillclimb", 4,
                         0, "measure")
    assert gru.backend == "cost" and gru.measured == {}


def test_measured_tuning_without_a_result_is_an_error(monkeypatch):
    monkeypatch.setattr(tune, "MeasuredGemmEvaluator",
                        lambda *a, **kw: FakeMeasured(*a, **kw,
                                                      score=float("inf")))
    with pytest.raises(tune.MeasureError, match="no finite result"):
        tune.tune_case(tune._gemm_case(256, 64, 256), gpu_sm(8),
                       "hillclimb", 4, 0, "measure")
