"""Search strategies over the Approach config space (paper Section 4).

Three drivers with one shared contract: ``strategy(space, evaluate, trials,
seed) -> SearchOutcome`` where ``evaluate(config) -> cost`` (lower is
better, ``inf`` = infeasible).  All strategies

  * are **deterministic** under a fixed seed (a private ``random.Random``),
  * evaluate the space's greedy-equivalent **baseline first**, so the
    reported best is never worse than ``GreedyApproach``,
  * dedupe configs, so a trial budget is a budget of *distinct* evaluations.

Ties are broken toward the earliest-evaluated config, i.e. toward the
baseline — search only moves off the paper's heuristics when a candidate is
strictly better.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable

from .space import Config, SearchSpace, config_key

Evaluator = Callable[[Config], float]


@dataclass(frozen=True)
class Trial:
    """One evaluated point."""

    index: int
    config: Config
    cost: float


@dataclass
class SearchOutcome:
    strategy: str
    best_config: Config
    best_cost: float
    baseline_cost: float
    trials: list[Trial] = field(default_factory=list)

    @property
    def evaluations(self) -> int:
        return len(self.trials)

    @property
    def speedup(self) -> float:
        """Modeled baseline/tuned ratio (>= 1.0 by construction)."""
        if self.best_cost <= 0:
            return 1.0
        return self.baseline_cost / self.best_cost


class _Scorer:
    """Batched scoring front-end.

    When the evaluator exposes ``evaluate_many`` (``CostModelEvaluator``),
    populations go through it in one call — vectorized guard, schedule-key
    memoization, incremental re-scheduling — and the per-config scores land
    in a local cache the scalar path reads back.  Scores are identical to
    calling ``evaluate(config)`` directly (the batch tier's contract), so
    strategies that prefetch stay bit-identical to the sequential path.
    """

    def __init__(self, evaluate: Evaluator):
        self.evaluate = evaluate
        self.many = getattr(evaluate, "evaluate_many", None)
        self.cache: dict[tuple, float] = {}

    def prefetch(self, configs: list[Config]) -> None:
        """Score a population ahead of the runner's walk (no-op for scalar
        evaluators — nothing would be saved by batching them)."""
        if self.many is None:
            return
        todo, seen = [], set()
        for c in configs:
            k = config_key(c)
            if k not in self.cache and k not in seen:
                seen.add(k)
                todo.append(c)
        if todo:
            for c, s in zip(todo, self.many(todo)):
                self.cache[config_key(c)] = float(s)

    def __call__(self, config: Config) -> float:
        k = config_key(config)
        got = self.cache.get(k)
        if got is None:
            got = float(self.many([config])[0] if self.many is not None
                        else self.evaluate(config))
            self.cache[k] = got
        return got


class _Runner:
    """Shared bookkeeping: dedup, trial log, best tracking."""

    def __init__(self, space: SearchSpace, evaluate: Evaluator, trials: int):
        self.space = space
        self.evaluate = evaluate
        self.scorer = _Scorer(evaluate)
        self.budget = max(1, trials)
        self.seen: set[tuple] = set()
        self.trials: list[Trial] = []
        self.best: Trial | None = None

    @property
    def exhausted(self) -> bool:
        return len(self.trials) >= self.budget

    def prefetch(self, configs: list[Config]) -> None:
        self.scorer.prefetch(configs)

    def run(self, config: Config) -> Trial | None:
        """Evaluate ``config`` unless duplicate / over budget."""
        key = config_key(config)
        if key in self.seen or self.exhausted:
            return None
        self.seen.add(key)
        cost = self.scorer(config)
        t = Trial(len(self.trials), dict(config), cost)
        self.trials.append(t)
        if self.best is None or cost < self.best.cost:
            self.best = t
        return t

    def outcome(self, strategy: str) -> SearchOutcome:
        baseline = self.trials[0].cost if self.trials else float("inf")
        assert self.best is not None
        return SearchOutcome(strategy=strategy,
                             best_config=dict(self.best.config),
                             best_cost=self.best.cost,
                             baseline_cost=baseline,
                             trials=list(self.trials))


def random_search(space: SearchSpace, evaluate: Evaluator,
                  trials: int = 32, seed: int = 0) -> SearchOutcome:
    """Baseline + uniform random sampling of distinct configs.

    The candidate stream and the accept/reject decisions are both
    cost-independent (the loop stops on budget / attempt count / dedupe
    only), so the exact consumed prefix is simulated up front and scored as
    one population; the runner walk below replays the sequential loop's
    decisions bit-identically."""
    rng = random.Random(seed)
    r = _Runner(space, evaluate, trials)
    base = space.baseline()
    sim_seen = {config_key(base)}
    n_trials, attempts, consumed = 1, 0, []
    while n_trials < r.budget and attempts < trials * 50:
        attempts += 1
        c = space.random_config(rng)
        consumed.append(c)
        k = config_key(c)
        if k not in sim_seen:
            sim_seen.add(k)
            n_trials += 1
    r.prefetch([base] + consumed)
    r.run(base)
    for c in consumed:
        r.run(c)
    return r.outcome("random")


def hill_climb(space: SearchSpace, evaluate: Evaluator,
               trials: int = 32, seed: int = 0) -> SearchOutcome:
    """Greedy first-improvement hill-climb from the baseline.

    The incumbent's single-mutation neighborhood is walked in the space's
    deterministic order; the first strictly better neighbor becomes the new
    incumbent (restarting the walk there).  A fully explored neighborhood
    with no improvement is a local optimum — the climb then restarts from a
    random config (the incumbent is global, so restarts can only help).
    The seed only influences restart points, so small budgets behave
    identically across seeds until the first local optimum.  The outcome's
    best is global across all restarts (the runner tracks it), while the
    climb itself descends from wherever it restarted."""
    rng = random.Random(seed)
    r = _Runner(space, evaluate, trials)
    current = r.run(space.baseline())

    def recenter(config: Config):
        """Materialize + batch-score the incumbent's neighborhood (which
        neighbors actually *run* still depends on the walk, but scoring the
        frontier as one population is what the throughput tier is for)."""
        neigh = list(space.neighbors(config))
        r.prefetch(neigh)
        return iter(neigh)

    frontier = recenter(current.config)
    attempts = 0
    while not r.exhausted and attempts < trials * 50:
        attempts += 1
        cand = next(frontier, None)
        if cand is None:               # local optimum: random restart
            restart = r.run(space.random_config(rng))
            if restart is not None:
                current = restart
                frontier = recenter(current.config)
            continue
        t = r.run(cand)
        if t is not None and t.cost < current.cost:
            current = t
            frontier = recenter(current.config)
    return r.outcome("hillclimb")


def evolutionary(space: SearchSpace, evaluate: Evaluator,
                 trials: int = 32, seed: int = 0,
                 population: int = 8, elite: int = 3) -> SearchOutcome:
    """(mu + lambda)-style beam/evolutionary search.

    Generation 0 is the baseline plus random configs; each later generation
    keeps the ``elite`` best evaluated so far as parents and fills the
    population with crossovers + mutations of the parents.

    Each generation is drawn in full before any of it is scored: within a
    generation the parents are fixed and a child's accept/reject depends
    only on dedupe (never on its cost), so the rng stream and the accepted
    set are simulated exactly, the batch goes through the evaluator as one
    population, and the runner replays the sequential decisions
    bit-identically.
    """
    rng = random.Random(seed)
    r = _Runner(space, evaluate, trials)
    base = space.baseline()
    gen0, sim_seen, sim_trials = [], {config_key(base)}, 1
    for _ in range(population - 1):
        if sim_trials >= r.budget:
            break
        c = space.random_config(rng)
        gen0.append(c)
        k = config_key(c)
        if k not in sim_seen:
            sim_seen.add(k)
            sim_trials += 1
    r.prefetch([base] + gen0)
    r.run(base)
    for c in gen0:
        r.run(c)
    attempts = 0
    while not r.exhausted and attempts < trials * 50:
        parents = sorted(r.trials, key=lambda t: (t.cost, t.index))[:elite]
        sim_seen = set(r.seen)
        sim_trials = len(r.trials)
        batch, made = [], 0
        while made < population and sim_trials < r.budget \
                and attempts + len(batch) < trials * 50:
            pa, pb = rng.choice(parents), rng.choice(parents)
            child = space.crossover(pa.config, pb.config, rng)
            child = space.mutate(child, rng, n_mutations=1)
            batch.append(child)
            k = config_key(child)
            if k not in sim_seen:
                sim_seen.add(k)
                sim_trials += 1
                made += 1
        r.prefetch(batch)
        made = 0
        for child in batch:
            attempts += 1
            if r.run(child) is not None:
                made += 1
        if made == 0:       # space exhausted around the elites
            break
    return r.outcome("evolve")


#: Above this size the surrogate ranks a seeded sample instead of the full
#: enumeration (predictions are cheap, but not free).
SURROGATE_POOL_CAP = 20_000


def surrogate_search(space: SearchSpace, evaluate: Evaluator,
                     trials: int = 32, seed: int = 0,
                     predict: Callable[[Config], float] | None = None,
                     seeds: list[Config] | None = None,
                     pool: int = 4096) -> SearchOutcome:
    """Surrogate-guided search: rank a large candidate pool by a *learned*
    cost predictor (``repro_torch.search.model``), then spend the real
    evaluation budget only on the top of the ranking.

    Budget split (all real evaluations go through the shared runner, so
    baseline-first and tuned <= greedy hold exactly as for the other
    strategies):

      1. the greedy-equivalent baseline (1 trial);
      1b. the ``seeds`` — a trained model carries the cache-winner configs
         of its program *family* as anchors (``CostModel.meta['anchors']``),
         so past winners for sibling shapes are tried first: the tuning
         cache's "remember winners" transferred across shapes.  At most
         half the budget, best-predicted first;
      2. **model-ordered local search** (~2/3 of the remaining budget):
         hill-climbing from the baseline, but each incumbent's
         single-mutation neighborhood is walked in *predicted-cost order*
         instead of the space's axis order — the same moves ``hill_climb``
         makes, reached in fewer real evaluations because the model fronts
         the promising mutations;
      3. **global probes** (the rest): the best-predicted configs of the
         whole space (enumerated when small, else a seeded sample), for
         optima the local walk cannot reach — this is where the surrogate
         pays off beyond accelerating hillclimb.

    Without a predictor there is nothing to rank, so the call degrades to
    ``hill_climb`` — the documented fallback when no model is trained.  The
    predictor may expose ``predict_many(configs)`` (the
    ``CostModel.predictor`` closure does) to score pools in one shot.
    """
    if predict is None:
        out = hill_climb(space, evaluate, trials=trials, seed=seed)
        out.strategy = "surrogate:fallback-hillclimb"
        return out

    rng = random.Random(seed)
    r = _Runner(space, evaluate, trials)
    r.run(space.baseline())

    # -- phase 1b: family anchors (cache winners), best-predicted first ----
    if seeds:
        sseeds = [dict(s) for s in seeds]
        s_scores = _predict_all(predict, sseeds)
        seed_budget = 1 + max(1, (trials - 1) // 2)
        r.prefetch(sseeds)
        for _, cand in sorted(zip(s_scores, sseeds), key=_rank_key):
            if len(r.trials) >= min(seed_budget, r.budget):
                break
            r.run(cand)

    # -- phase 2: model-ordered first-improvement local search -------------
    global_budget = max(1, (trials - 1) // 3)
    assert r.best is not None
    current = r.best

    def recenter(config: Config):
        frontier = _ordered_neighbors(space, predict, config, r.seen)
        r.prefetch(frontier)
        return iter(frontier)

    frontier = recenter(current.config)
    while len(r.trials) < r.budget - global_budget:
        cand = next(frontier, None)
        if cand is None:               # neighborhood exhausted: local optimum
            break
        t = r.run(cand)
        if t is not None and t.cost < current.cost:
            current = t                # first improvement: re-center
            frontier = recenter(current.config)

    # -- phase 3: global top-predicted probes ------------------------------
    if space.size() <= SURROGATE_POOL_CAP:
        candidates = list(space.enumerate_configs())
    else:                                   # pragma: no cover - huge spaces
        candidates = list(space.neighbors(space.baseline()))
        seen = {config_key(c) for c in candidates}
        while len(candidates) < pool:
            c = space.random_config(rng)
            if config_key(c) not in seen:
                seen.add(config_key(c))
                candidates.append(c)
    candidates = [c for c in candidates if config_key(c) not in r.seen]
    scores = _predict_all(predict, candidates)
    ranked = [c for _, c in sorted(zip(scores, candidates), key=_rank_key)]
    # the candidates are distinct and unseen, so exactly the remaining
    # budget's worth will run — batch-score just that prefix
    r.prefetch(ranked[:max(0, r.budget - len(r.trials))])
    for cand in ranked:
        if r.exhausted:
            break
        r.run(cand)
    return r.outcome("surrogate")


def _ordered_neighbors(space: SearchSpace, predict, config: Config,
                       seen: set) -> list[Config]:
    """The unseen single-mutation neighborhood of ``config``, best-predicted
    first (deterministic ties — see ``_rank_key``)."""
    neigh = [c for c in space.neighbors(config) if config_key(c) not in seen]
    scores = _predict_all(predict, neigh)
    return [c for _, c in sorted(zip(scores, neigh), key=_rank_key)]


def _rank_key(sc):
    """Deterministic (score, config) ordering: ties break on the config's
    canonical *string* form — config values mix None/int/str, which are not
    mutually comparable, and prediction ties do happen (policy dims a model
    learned to ignore produce identical scores)."""
    return (sc[0], repr(config_key(sc[1])))


def _predict_all(predict, configs: list[Config]) -> list[float]:
    many = getattr(predict, "predict_many", None)
    if many is not None:
        return [float(s) for s in many(configs)]
    return [float(predict(c)) for c in configs]


STRATEGIES: dict[str, Callable[..., SearchOutcome]] = {
    "random": random_search,
    "hillclimb": hill_climb,
    "evolve": evolutionary,
    "surrogate": surrogate_search,
}
