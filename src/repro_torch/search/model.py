"""Learned cost model over ``ParamApproach`` config vectors (paper Section 4).

The paper's search framework explicitly reserves a slot for "machine
learning to facilitate this search problem".  This module is that leg: a
deterministic, numpy-only **ridge regression** over the engineered feature
vectors of ``repro_torch.compile.features``, trained on records harvested from
the
persistent tuning cache plus fresh ``CostModelEvaluator`` labels, predicting
``log(modeled cost)``.

Why ridge, not a tree/NN: the training sets are small (tens to a few
thousand labels), the features are engineered to be near-linear in log-cost,
closed-form ridge is exactly reproducible across platforms (one
``np.linalg.solve``), and the whole artifact — feature names, scaler,
weights — round-trips through JSON in a few hundred bytes.

Model artifacts are keyed like tuning records — ``(program family, sysgraph
fingerprint, backend, torch version)`` — and live in a ``ModelStore`` JSON
file (``REPRO_TORCH_MODEL_STORE``, default
``~/.cache/repro_torch/models.json``; never one the JAX package writes).
Consumers:

  * ``search.evaluate.LearnedEvaluator`` — scores configs by prediction
    (microseconds) instead of scheduling them (milliseconds to seconds);
  * ``search.strategies.surrogate_search`` — ranks a large candidate pool by
    predicted cost and spends the real trial budget on the top of the
    ranking;
  * ``kernels.gemm.tuned_block`` — on a tuning-cache miss, a process-default
    model picks K1's block for never-tuned shapes (on ``gpu_sm(8)``; the
    launch maps it to a CUDA tile with ``route_tile``).

CLI (``--target``, default ``gpu_sm``, as the tuner's)::

    python -m repro_torch.search.model train --suite gemm,conv --cache PATH \\
        --store PATH [--samples N] [--holdout F] [--json PATH]
    python -m repro_torch.search.model eval  --store PATH --suite gemm \\
        [--samples N] [--topk K] [--json PATH]
    python -m repro_torch.search.model export --store PATH [--key KEY] \\
        [--out P]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import random
import sys
from dataclasses import dataclass, field

import numpy as np

from ..compile.features import (FEATURE_SCHEMA, feature_dict, feature_names,
                                program_family, role_extents)
from ..compile.keys import sysgraph_fingerprint, torch_version
from ..core.ir import Program
from ..core.sysgraph import SystemGraph
from .cache import CACHE_ERRORS, JsonStore, TuningCache
from .space import Config, SearchSpace, config_key

MODEL_SCHEMA = 1

#: Override the default model-store location (e.g. in CI).
MODEL_ENV_VAR = "REPRO_TORCH_MODEL_STORE"

#: Below this many training labels a family model is not trained at all —
#: callers fall back to the analytical cost backend.
MIN_TRAIN_SAMPLES = 16


def default_store_path() -> str:
    env = os.environ.get(MODEL_ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "models.json")


def model_key(family: str, graph: SystemGraph | str,
              backend: str = "cost") -> str:
    """Mirror of ``space.tuning_key`` at program-*family* granularity: one
    model covers every shape of a family on one machine/toolchain."""
    if isinstance(graph, SystemGraph):
        gname = f"{graph.name}@{sysgraph_fingerprint(graph)}"
    else:
        gname = graph
    return f"{family}|{gname}|{backend}|torch={torch_version()}"


# --------------------------------------------------------------------------- #
# Samples
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Sample:
    """One training label: a config and its (modeled) cost on a program.
    ``roles`` carries the matmul role extents of the case's selection, so
    tile-cap features bind against the right axes (conv extractions map
    the MXU roles onto fused haystack axes)."""

    config: dict
    cost: float                 # seconds, > 0 and finite
    program: Program
    case: str = ""
    source: str = "fresh"       # 'cache' | 'fresh'
    roles: dict = field(default_factory=dict)


def harvest_cache(cache: TuningCache, cases, graph: SystemGraph,
                  backend: str = "cost") -> list[Sample]:
    """Labels mined from the persistent tuning cache: every matching record
    contributes its winner (config, cost) and its baseline (greedy config,
    baseline cost).  ``cases`` are ``tune.TuneCase``-likes (``.program`` +
    ``.name``); records are matched by tuning key, so only cases actually
    tuned on this graph/backend/toolchain yield samples."""
    from .space import tuning_key
    out: list[Sample] = []
    space = SearchSpace.for_graph(graph)
    for case in cases:
        try:
            rec = cache.lookup(tuning_key(case.program, graph, backend))
        except CACHE_ERRORS:
            rec = None
        if rec is None:
            continue
        roles = role_extents(case.selection)
        if np.isfinite(rec.cost) and rec.cost > 0 and rec.config:
            out.append(Sample(dict(rec.config), float(rec.cost),
                              case.program, case.name, "cache", roles))
        if np.isfinite(rec.baseline_cost) and rec.baseline_cost > 0:
            out.append(Sample(space.baseline(), float(rec.baseline_cost),
                              case.program, case.name, "cache", roles))
    return out


def fresh_labels(case, graph: SystemGraph, n: int = 48, seed: int = 0,
                 anchors: list[Config] | None = None,
                 baseline_pool: bool = True) -> list[Sample]:
    """Fresh ``CostModelEvaluator`` labels for one case: the baseline, a
    deterministic walk of its single-mutation neighborhood, then seeded
    random configs — the same candidate distribution the strategies explore,
    so the model trains on the region it will be asked to rank.  ``anchors``
    (e.g. harvested cache winners) and their neighborhoods are labeled too:
    the data flywheel concentrates samples where past searches found wins.
    Infeasible configs (``inf``) are skipped (log-cost is undefined).

    ``baseline_pool=False`` drops the deterministic baseline-neighborhood
    block and labels seeded-random configs only — what a held-out *eval*
    set needs, since training always contains that block (``topk_regret``
    must not score the model on its own training points)."""
    from .evaluate import CostModelEvaluator
    rng = random.Random(seed)
    space = SearchSpace.for_graph(graph)
    ev = CostModelEvaluator(case.selection, graph)
    pool: list[Config] = []
    if baseline_pool:
        pool.append(space.baseline())
        pool += list(space.neighbors(space.baseline()))
    for a in (anchors or []):
        pool.append(dict(a))
        pool += list(space.neighbors(a))
    configs, seen = [], set()
    for c in pool:
        if config_key(c) not in seen:
            seen.add(config_key(c))
            configs.append(c)
    attempts = 0
    while len(configs) < n and attempts < n * 50:
        attempts += 1
        c = space.random_config(rng)
        if config_key(c) not in seen:
            seen.add(config_key(c))
            configs.append(c)
    roles = role_extents(case.selection)
    cut = max(n, len(pool)) if anchors else n   # always label the anchors
    out = []
    for c in configs[:cut]:
        cost = ev(c)
        if np.isfinite(cost) and cost > 0:
            out.append(Sample(dict(c), float(cost), case.program,
                              case.name, "fresh", roles))
    return out


# --------------------------------------------------------------------------- #
# The ridge model
# --------------------------------------------------------------------------- #


@dataclass
class CostModel:
    """Closed-form ridge regression predicting log(cost seconds).

    ``names`` is the feature schema the weights are aligned to; prediction
    recomputes features by name, so a model stays valid as long as the
    feature definitions (``FEATURE_SCHEMA``) do."""

    key: str
    family: str
    names: tuple[str, ...]
    weights: np.ndarray          # (n_features,)
    intercept: float
    x_mean: np.ndarray
    x_scale: np.ndarray
    alpha: float = 1.0
    n_samples: int = 0
    feature_schema: int = FEATURE_SCHEMA
    meta: dict = field(default_factory=dict)

    # -- fit / predict -------------------------------------------------------
    @classmethod
    def fit(cls, key: str, family: str, names: tuple[str, ...],
            X: np.ndarray, y_cost: np.ndarray, alpha: float = 1.0,
            meta: dict | None = None) -> "CostModel":
        """Ridge on standardized features vs log-cost.  Deterministic: no
        iteration, no randomness — one normal-equations solve."""
        X = np.asarray(X, np.float64)
        y = np.log(np.asarray(y_cost, np.float64))
        mean = X.mean(axis=0)
        scale = X.std(axis=0)
        scale[scale < 1e-12] = 1.0
        Z = (X - mean) / scale
        n = Z.shape[1]
        A = Z.T @ Z + alpha * np.eye(n)
        w = np.linalg.solve(A, Z.T @ (y - y.mean()))
        return cls(key=key, family=family, names=tuple(names), weights=w,
                   intercept=float(y.mean()), x_mean=mean, x_scale=scale,
                   alpha=float(alpha), n_samples=int(len(y)),
                   meta=dict(meta or {}))

    def predict_rows(self, X: np.ndarray) -> np.ndarray:
        """Predicted cost (seconds) for rows already in ``names`` order.
        The reshape keeps an *empty* batch well-formed — ``np.array([])``
        is shape (0,), which would not broadcast against the scaler."""
        X = np.asarray(X, np.float64).reshape(-1, len(self.names))
        Z = (X - self.x_mean) / self.x_scale
        return np.exp(Z @ self.weights + self.intercept)

    def predict(self, config: Config, prog: Program, graph: SystemGraph,
                roles: dict | None = None) -> float:
        return float(self.predict_rows(
            _rows([config], prog, graph, self.names, roles))[0])

    def predictor(self, prog: Program, graph: SystemGraph,
                  roles: dict | None = None):
        """A fast ``config -> predicted cost`` closure with the static
        (program/graph/role) features precomputed once.  Also exposes
        ``.predict_many(configs) -> np.ndarray`` for pool ranking."""
        from ..compile.features import (_default_roles, _interactions,
                                        config_features)
        roles = roles or _default_roles(prog)
        static = feature_dict({}, prog, graph, roles)
        rf = {k: static[k] for k in static if k.startswith("log_role_")}
        hw = graph.min_matmul_tile()

        def row(config: Config) -> list[float]:
            cfg = config_features(config, hw, roles)
            d = {**static, **cfg, **_interactions(cfg, static, rf)}
            return [d[n] for n in self.names]

        def predict_many(configs) -> np.ndarray:
            return self.predict_rows(np.array([row(c) for c in configs],
                                              np.float64))

        def predict_one(config: Config) -> float:
            return float(predict_many([config])[0])

        predict_one.predict_many = predict_many
        predict_one.model = self
        return predict_one

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema": MODEL_SCHEMA, "key": self.key,
                "family": self.family, "names": list(self.names),
                "weights": [float(w) for w in self.weights],
                "intercept": self.intercept,
                "x_mean": [float(v) for v in self.x_mean],
                "x_scale": [float(v) for v in self.x_scale],
                "alpha": self.alpha, "n_samples": self.n_samples,
                "feature_schema": self.feature_schema,
                "meta": dict(self.meta)}

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        m = cls(key=d["key"], family=d.get("family", ""),
                names=tuple(d.get("names", [])),
                weights=np.asarray(d.get("weights", []), np.float64),
                intercept=float(d.get("intercept", 0.0)),
                x_mean=np.asarray(d.get("x_mean", []), np.float64),
                x_scale=np.asarray(d.get("x_scale", []), np.float64),
                alpha=float(d.get("alpha", 1.0)),
                n_samples=int(d.get("n_samples", 0)),
                feature_schema=int(d.get("feature_schema", -1)),
                meta=dict(d.get("meta", {})))
        if m.feature_schema != FEATURE_SCHEMA:
            raise ValueError(
                f"model {m.key!r} was trained with feature schema "
                f"{m.feature_schema}, current is {FEATURE_SCHEMA}")
        if not (len(m.names) == len(m.weights) == len(m.x_mean)
                == len(m.x_scale)):
            raise ValueError(f"model {m.key!r} has inconsistent shapes")
        return m


def _rows(configs, prog: Program, graph: SystemGraph,
          names: tuple[str, ...], roles: dict | None = None) -> np.ndarray:
    return np.array([[feature_dict(c, prog, graph, roles)[n] for n in names]
                     for c in configs], np.float64)


def train_family(key: str, family: str, samples: list[Sample],
                 graph: SystemGraph, alpha: float = 1.0,
                 holdout: float = 0.25, seed: int = 0
                 ) -> tuple[CostModel | None, dict]:
    """Fit one family model on ``samples``; returns ``(model, metrics)``.
    ``model`` is ``None`` (and metrics say why) below ``MIN_TRAIN_SAMPLES``.
    The holdout split is a seeded shuffle, so metrics are reproducible."""
    if len(samples) < MIN_TRAIN_SAMPLES:
        return None, {"key": key, "family": family, "trained": False,
                      "reason": f"{len(samples)} samples "
                                f"< {MIN_TRAIN_SAMPLES} required",
                      "n_samples": len(samples)}
    names = feature_names(samples[0].program, graph)
    order = list(range(len(samples)))
    random.Random(seed).shuffle(order)
    n_hold = int(len(order) * holdout) if len(order) >= 8 else 0
    hold, tr = order[:n_hold], order[n_hold:]

    def matrix(idx):
        X = np.concatenate([_rows([samples[i].config], samples[i].program,
                                  graph, names, samples[i].roles or None)
                            for i in idx])
        y = np.array([samples[i].cost for i in idx], np.float64)
        return X, y

    Xtr, ytr = matrix(tr)
    model = CostModel.fit(key, family, names, Xtr, ytr, alpha=alpha,
                          meta={"sources": _source_counts(samples),
                                "holdout": n_hold, "seed": seed,
                                "anchors": _anchor_configs(samples, graph)})
    metrics = {"key": key, "family": family, "trained": True,
               "n_samples": len(samples), "n_train": len(tr),
               "n_holdout": n_hold, "alpha": alpha,
               "sources": _source_counts(samples)}
    pred_tr = model.predict_rows(Xtr)
    metrics["train_mae_log"] = float(
        np.mean(np.abs(np.log(pred_tr) - np.log(ytr))))
    if n_hold:
        Xh, yh = matrix(hold)
        pred = model.predict_rows(Xh)
        metrics["holdout_mae_log"] = float(
            np.mean(np.abs(np.log(pred) - np.log(yh))))
        metrics["holdout_mape"] = float(
            np.mean(np.abs(pred - yh) / yh))
    return model, metrics


#: Cap on the winner configs a model artifact carries as search seeds.
MAX_ANCHORS = 16


def _anchor_configs(samples: list[Sample], graph: SystemGraph) -> list[dict]:
    """The cache-winner configs among ``samples``, deduped and ordered by
    their recorded cost — the family's "known good" set.  Stored in the
    model artifact so surrogate-guided search can seed its real trials with
    past winners (the tuning cache's "remember winners" philosophy lifted
    from exact program keys to the whole program family)."""
    base = config_key(SearchSpace.for_graph(graph).baseline())
    winners = [s for s in sorted(samples, key=lambda s: s.cost)
               if s.source == "cache" and s.config
               and config_key(s.config) != base]
    out, seen = [], set()
    for s in winners:
        k = config_key(s.config)
        if k not in seen:
            seen.add(k)
            out.append(dict(s.config))
        if len(out) >= MAX_ANCHORS:
            break
    return out


def _source_counts(samples: list[Sample]) -> dict:
    counts: dict[str, int] = {}
    for s in samples:
        counts[s.source] = counts.get(s.source, 0) + 1
    return counts


# --------------------------------------------------------------------------- #
# ModelStore — JSON persistence, keyed like the tuning cache
# --------------------------------------------------------------------------- #


class ModelStore(JsonStore):
    """Dict of ``CostModel`` artifacts with JSON persistence — the same
    lazy-load / merge-on-save / atomic-replace behavior as ``TuningCache``
    (both derive from ``cache.JsonStore``).  Models whose feature schema
    drifted fail ``CostModel.from_dict`` and are skipped on load — the
    graceful no-model fallback, not a crash."""

    payload_key = "models"
    schema = MODEL_SCHEMA

    def default_path(self) -> str:
        return default_store_path()

    def _decode(self, d: dict) -> CostModel:
        return CostModel.from_dict(d)

    def model_for(self, prog: Program | str, graph: SystemGraph,
                  backend: str = "cost") -> CostModel | None:
        return self.lookup(model_key(program_family(prog), graph, backend))


_default_store: ModelStore | None = None


def get_default_store() -> ModelStore | None:
    """The process-wide model store, if one was activated
    (``set_default_store``: the smoke run's ``learned`` phase, tests).
    Unlike the tuning cache this defaults to **None**: learned predictions
    only happen when explicitly opted in."""
    return _default_store


def set_default_store(store: ModelStore | None) -> None:
    global _default_store
    _default_store = store


def predict_gemm_block(m: int, n: int, k: int, store: ModelStore | None = None,
                       graph: SystemGraph | None = None
                       ) -> tuple[int, int, int] | None:
    """Model-picked (bm, bn, bk) block for a *never-tuned* GEMM shape on
    ``graph`` (default ``gpu_sm(8)``, the graph the port's kernels schedule
    against): rank the tile sub-space (policies at baseline) plus the
    model's anchors by predicted cost and return the winner's resolved
    tile.  ``None`` when no model store is active or no matmul-family model
    exists — the caller (``kernels.gemm.tuned_block``) then returns
    ``None`` and the launch takes its route's default tile.  Pure numpy.

    Candidates go through the same tile-count guard the search evaluators
    use — the model never trains on infeasible points, so an extrapolating
    prediction must not be able to hand a degenerate block to a real
    kernel."""
    store = store if store is not None else get_default_store()
    if store is None:
        return None
    from ..compile import gemm_selection
    from ..core.sysgraph import gpu_sm
    from .evaluate import CostModelEvaluator, gemm_tile_for
    graph = graph if graph is not None else gpu_sm(8)
    try:
        prog, sel = gemm_selection(m, n, k)
        model = store.model_for(prog, graph)
    except CACHE_ERRORS:
        return None
    if model is None:
        return None
    guard = CostModelEvaluator(sel, graph)
    space = SearchSpace.for_graph(graph)
    base = space.baseline()
    tile_axes = [a for a in space.axes if a.name.startswith("tile_")]
    pool = [dict(base)]
    for values in itertools.product(*(a.choices for a in tile_axes)):
        pool.append({**base, **dict(zip((a.name for a in tile_axes),
                                        values))})
    pool += [dict(a) for a in model.meta.get("anchors", [])]
    from .space import ParamApproach
    configs = [c for c in pool
               if guard.estimated_tiles(ParamApproach(c)) <= guard.max_tiles]
    if not configs:
        return None
    pred = model.predictor(prog, graph)
    scores = pred.predict_many(configs)
    order = np.argsort(np.asarray(scores), kind="stable")
    best = configs[int(order[0])]
    return gemm_tile_for(best, graph, m, n, k)


# --------------------------------------------------------------------------- #
# Train / eval drivers (shared by the CLI and the smoke run)
# --------------------------------------------------------------------------- #


def _suite_cases(suites: str):
    from .tune import build_cases
    cases = []
    for s in suites.split(","):
        s = s.strip()
        if s:
            cases += build_cases("all" if s == "all" else s)
    return cases


def train_suites(suites: str, graph: SystemGraph, cache: TuningCache,
                 store: ModelStore, samples_per_case: int = 48,
                 alpha: float = 1.0, holdout: float = 0.25, seed: int = 0,
                 backend: str = "cost") -> list[dict]:
    """Harvest (cache + fresh) -> group by family -> fit -> store.  Returns
    one metrics row per family; untrainable families report why."""
    cases = _suite_cases(suites)
    samples = harvest_cache(cache, cases, graph, backend)
    winners: dict[str, list[dict]] = {}
    for s in samples:
        if s.config and s.source == "cache":
            winners.setdefault(s.case, []).append(s.config)
    for i, case in enumerate(cases):
        samples += fresh_labels(case, graph, n=samples_per_case,
                                seed=seed + i,
                                anchors=winners.get(case.name))
    by_family: dict[str, list[Sample]] = {}
    for s in samples:
        by_family.setdefault(program_family(s.program), []).append(s)
    rows = []
    for family in sorted(by_family):
        key = model_key(family, graph, backend)
        model, metrics = train_family(key, family, by_family[family], graph,
                                      alpha=alpha, holdout=holdout, seed=seed)
        if model is not None:
            store.store(model, save=False)
        rows.append(metrics)
    store.save()
    return rows


def topk_regret(model: CostModel, case, graph: SystemGraph,
                samples: int = 32, topk: int = 8, seed: int = 1) -> dict:
    """Ranking quality on *held-out* labels: evaluate ``samples`` candidate
    configs with the real cost backend, rank them by model prediction, and
    report ``regret@k`` = (best true cost within the predicted top-k) /
    (best true cost overall).  1.0 means the model's top-k contains the true
    winner — exactly the property surrogate-guided search relies on.

    The candidates are seeded-random only (no baseline-neighborhood block —
    training always labels that block, so including it would score the
    model on its own training points) under a seed offset far from the
    per-case training seeds; residual overlap is down to random collision."""
    labeled = fresh_labels(case, graph, n=samples,
                           seed=seed * 7919 + 104_729,
                           baseline_pool=False)
    if len(labeled) < 2:
        # Not enough feasible labels to rank anything; regret is
        # unmeasurable (None keeps the JSON report strict-parseable).
        return {"case": case.name, "regret_at_k": None,
                "n_labeled": len(labeled)}
    pred = model.predictor(case.program, graph, role_extents(case.selection))
    scores = pred.predict_many([s.config for s in labeled])
    true = np.array([s.cost for s in labeled])
    k = min(topk, len(labeled))
    top = np.argsort(scores, kind="stable")[:k]
    best_all = float(true.min())
    best_topk = float(true[top].min())
    mae = float(np.mean(np.abs(np.log(scores) - np.log(true))))
    return {"case": case.name, "n_labeled": len(labeled), "topk": k,
            "best_true": best_all, "best_in_topk": best_topk,
            "regret_at_k": best_topk / best_all if best_all > 0 else 1.0,
            "mae_log": mae}


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #


def _add_common(ap):
    from .tune import GRAPH_NAMES
    ap.add_argument("--store", default=None,
                    help=f"model store path (default {default_store_path()})")
    ap.add_argument("--target", choices=list(GRAPH_NAMES), default="gpu_sm",
                    help="modeled hardware target (as the tuner's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="write the report here")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.search.model",
        description="Train / evaluate / export the learned cost model.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="harvest cache + fresh labels, fit, "
                                      "store per-family ridge models")
    tr.add_argument("--suite", default="gemm,conv",
                    help="comma list of gemm/gru/conv, or 'all'")
    tr.add_argument("--cache", default=None,
                    help="tuning cache to harvest (default: the "
                         "repro_torch.search default cache)")
    tr.add_argument("--samples", type=int, default=48,
                    help="fresh CostModelEvaluator labels per case")
    tr.add_argument("--alpha", type=float, default=1.0)
    tr.add_argument("--holdout", type=float, default=0.25)
    _add_common(tr)

    ev = sub.add_parser("eval", help="holdout-style ranking eval: "
                                     "MAE + top-k regret vs the cost backend")
    ev.add_argument("--suite", default="gemm")
    ev.add_argument("--samples", type=int, default=32)
    ev.add_argument("--topk", type=int, default=8)
    _add_common(ev)

    ex = sub.add_parser("export", help="list stored models, or export one "
                                       "as a standalone JSON artifact")
    ex.add_argument("--key", default=None)
    ex.add_argument("--out", default=None)
    _add_common(ex)

    args = ap.parse_args(argv)
    from .tune import make_graph
    graph = make_graph(args.target)
    store = ModelStore(args.store)

    if args.cmd == "train":
        cache = TuningCache(args.cache)
        rows = train_suites(args.suite, graph, cache, store,
                            samples_per_case=args.samples, alpha=args.alpha,
                            holdout=args.holdout, seed=args.seed)
        trained = [r for r in rows if r.get("trained")]
        for r in rows:
            if r.get("trained"):
                mae = r.get("holdout_mae_log", r.get("train_mae_log"))
                print(f"[ok] {r['family']}: {r['n_samples']} samples "
                      f"(cache={r['sources'].get('cache', 0)} "
                      f"fresh={r['sources'].get('fresh', 0)}), "
                      f"mae_log={mae:.4f}")
            else:
                print(f"[skip] {r['family']}: {r['reason']}")
        print(f"# wrote {len(trained)} model(s) to {store.path}")
        _write_json(args.json, {"schema": 1, "cmd": "train",
                                "store": store.path, "rows": rows})
        return 0 if trained else 1

    if args.cmd == "eval":
        rows = []
        regrets = []
        for case in _suite_cases(args.suite):
            model = store.model_for(case.program, graph)
            if model is None:
                rows.append({"case": case.name, "error": "no model"})
                print(f"[skip] {case.name}: no model in {store.path}")
                continue
            r = topk_regret(model, case, graph, samples=args.samples,
                            topk=args.topk, seed=args.seed + 1)
            rows.append(r)
            if r.get("regret_at_k") is None:
                # Too few feasible labels to rank: report it, never fold an
                # unmeasured case into worst_regret (it would read as a
                # perfect score).
                print(f"[skip] {case.name}: only {r['n_labeled']} feasible "
                      "label(s), regret unmeasurable")
                continue
            regrets.append(r["regret_at_k"])
            print(f"[ok] {case.name}: regret@{r['topk']}="
                  f"{r['regret_at_k']:.3f} mae_log={r['mae_log']:.4f} "
                  f"({r['n_labeled']} labels)")
        worst = max(regrets, default=None)
        _write_json(args.json, {"schema": 1, "cmd": "eval",
                                "store": store.path, "topk": args.topk,
                                "worst_regret": worst,
                                "unmeasured": len(rows) - len(regrets),
                                "rows": rows})
        return 0 if regrets else 1

    # export
    models = store.load()
    if args.key is None:
        for key, m in sorted(models.items()):
            print(f"{key}: {len(m.names)} features, "
                  f"{m.n_samples} samples")
        _write_json(args.json, {"schema": 1, "cmd": "export",
                                "keys": sorted(models)})
        return 0 if models else 1
    m = models.get(args.key)
    if m is None:
        print(f"no model for key {args.key!r} in {store.path}",
              file=sys.stderr)
        return 2
    payload = m.to_dict()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"# exported {args.key} -> {args.out}")
    else:
        json.dump(payload, sys.stdout, indent=2, sort_keys=True)
        print()
    return 0


def _write_json(path, payload) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"# report: {path}")


if __name__ == "__main__":
    raise SystemExit(main())
