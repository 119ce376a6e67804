"""Autotuner CLI — joint mapping/schedule search with a persistent cache.

    PYTHONPATH=src python -m repro_torch.search.tune --suite gemm --trials 32 \\
        --backend cost [--strategy hillclimb] [--cache PATH] [--json PATH]

Suites (the paper's evaluation set, Section 6):

  * ``gemm``   — the DeepBench GEMM shapes of Figure 3,
  * ``gru``    — the GRU cell (Figure 4 sizes),
  * ``fabric`` — distributed GEMMs on a modelled multi-chip fabric
                 (``--chips`` / ``--topology``): tunes (partition axis,
                 collective algorithm, per-chip tiles) *jointly* against the
                 ``repro_torch.fabric`` event-driven simulator, anchored to
                 the untuned multi-chip baseline (axis=m, ring, greedy
                 tiles); cost backend only.

Backends: ``cost`` scores a candidate by the modeled makespan of its
schedule on the target (numpy only, no card); ``measure`` times K1
(``csrc/gemm.cu``) at the candidate's tile on the CUDA card with CUDA
events.  ``measure`` needs the card: without one the run exits non-zero and
writes no record.  GRU cases stay on the cost backend (there is no measured
GRU kernel).  Measured runs tune one case at a time (``--workers 1``), so no
two timings share the card.

For every case the tuner (1) maps + selects instructions once, (2) searches
the ParamApproach config space with the chosen strategy — the greedy-
equivalent baseline is always trial 0, so the reported best can only match
or beat ``GreedyApproach`` — (3) replays the winning schedule through
``core.executor`` against the ``ir.interpret`` oracle on a capped-size proxy
of the same program (full DeepBench shapes do not fit a NumPy oracle), and
(4) stores the winner in the port's persistent cache, where
``kernels/gemm.py`` (``tile=None``) and ``kernels/ops.py`` (``plan_gemm``)
pick it up at run time.

Exit status: 0 iff every case tuned (cost <= greedy) and validated.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass, field

from ..compile import gemm_selection, gru_selection
from ..core.ir import Program
from ..core.isel import Selection
from ..core.sysgraph import SystemGraph, gpu_sm
from .cache import TuningCache, TuningRecord, default_cache_path
from .evaluate import (CostModelEvaluator, MeasuredGemmEvaluator,
                       ValidationReport, gemm_tile_for, validate_selection)
from .space import ParamApproach, SearchSpace, tuning_key
from .strategies import STRATEGIES, SearchOutcome

# DeepBench train/inference GEMM shapes (paper Figure 3): a library-friendly
# head and the awkward odd/skinny tail.
DEEPBENCH_GEMM_SIZES = [
    (1024, 128, 1024),
    (2048, 64, 2048),
    (1760, 128, 1760),
    (2560, 64, 2560),
    (5124, 700, 2048),
    (3072, 128, 1024),
    (35, 700, 2048),
    (7680, 1, 2560),
]

# DeepBench RNN sizes (batch, hidden), input = hidden (paper Figure 4).
GRU_SIZES = [(16, 256), (32, 512)]

#: Validation proxies cap each axis so the NumPy oracle stays tractable.
VALIDATE_DIM_CAP = 192

# Fabric-suite shapes: one large library-friendly GEMM and one awkward one.
FABRIC_GEMM_SIZES = [(5124, 700, 2048), (1760, 128, 1760)]


@dataclass
class TuneCase:
    """One tunable workload: full-size program for costing + a small proxy
    for oracle validation (same mapping structure, capped extents)."""

    name: str
    program: Program                  # full-size (possibly transformed)
    selection: Selection
    original: Program                 # pre-transform program (oracle input)
    proxy_original: Program
    proxy_selection: Selection
    gemm_shape: tuple[int, int, int] | None = None


def _gemm_case(m: int, n: int, k: int) -> TuneCase:
    prog, sel = gemm_selection(m, n, k)
    proxy, psel = gemm_selection(min(m, VALIDATE_DIM_CAP),
                                 min(n, VALIDATE_DIM_CAP),
                                 min(k, VALIDATE_DIM_CAP))
    return TuneCase(f"gemm_{m}x{n}x{k}", prog, sel, prog, proxy, psel,
                    gemm_shape=(m, n, k))


def _gru_case(batch: int, hidden: int) -> TuneCase:
    prog, sel = gru_selection(batch, hidden)
    proxy, psel = gru_selection(min(batch, 4), min(hidden, 16))
    return TuneCase(f"gru_{batch}x{hidden}", prog, sel, prog, proxy, psel)


def build_cases(suite: str, limit: int | None = None) -> list[TuneCase]:
    cases: list[TuneCase] = []
    if suite == "gemm":
        cases += [_gemm_case(*s) for s in DEEPBENCH_GEMM_SIZES]
    if suite == "gru":
        cases += [_gru_case(*s) for s in GRU_SIZES]
    return cases[:limit] if limit else cases


#: ``--target`` vocabulary of the tuner: the modeled GPU, the port's only
#: target.
GRAPH_NAMES = ("gpu", "gpu_sm")


def make_graph(name: str) -> SystemGraph:
    if name not in GRAPH_NAMES:
        raise ValueError(f"unknown target {name!r}: need one of {GRAPH_NAMES}")
    return gpu_sm(8)


class MeasureError(RuntimeError):
    """The measured backend produced no usable result for a case."""


@dataclass
class CaseReport:
    name: str
    key: str
    backend: str                # effective backend ('measure' downgrades to
    greedy_cost: float          # 'cost' for cases without a measured kernel)
    tuned_cost: float
    outcome: SearchOutcome
    validation: ValidationReport | None
    elapsed_s: float
    config: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)  # evaluator EvalStats + rates
    #: 'measure' only: the card, the torch and CUDA versions, the measured
    #: seconds of the recorded config (``measured_s``) and the best measured
    #: seconds of each CUDA tile tried (``tiles_s``)
    measured: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        if self.tuned_cost > self.greedy_cost:
            return False
        return self.validation is None or self.validation.ok

    def row(self) -> dict:
        return {
            "case": self.name, "key": self.key,
            "greedy_cost_s": self.greedy_cost,
            "tuned_cost_s": self.tuned_cost,
            "speedup": (self.greedy_cost / self.tuned_cost
                        if self.tuned_cost else 1.0),
            "trials": self.outcome.evaluations,
            "strategy": self.outcome.strategy,
            "config": self.config,
            "validated": None if self.validation is None
            else self.validation.ok,
            "exact": None if self.validation is None
            else self.validation.exact,
            "max_abs_err": None if self.validation is None
            else self.validation.max_abs_err,
            "elapsed_s": round(self.elapsed_s, 3),
            "counters": self.counters,
            "backend": self.backend,
            "measured_s": self.measured.get("measured_s"),
        }


def _card(evaluate: MeasuredGemmEvaluator) -> dict:
    """What a measured record says about where it was measured."""
    import torch
    return {"device": torch.cuda.get_device_name(evaluate.device),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def tune_case(case: TuneCase, graph: SystemGraph, strategy: str,
              trials: int, seed: int, backend: str,
              validate: bool = True) -> CaseReport:
    t0 = time.time()
    space = SearchSpace.for_graph(graph)
    cost_eval = CostModelEvaluator(case.selection, graph)
    if backend == "measure" and case.gemm_shape is not None:
        m, n, k = case.gemm_shape
        evaluate = MeasuredGemmEvaluator(m, n, k, graph, seed=seed)
    else:
        backend = "cost"
        evaluate = cost_eval

    outcome = STRATEGIES[strategy](space, evaluate, trials=trials, seed=seed)
    if evaluate is not cost_eval and not math.isfinite(outcome.best_cost):
        # A "measure" record would be meaningless yet preferred by
        # lookup_gemm; falling back to the cost model would hide the card.
        raise MeasureError(f"{case.name}: the measured backend produced no "
                           "finite result")
    measured = {}
    if evaluate is not cost_eval:
        tiles: dict[str, float] = {}        # best seconds per CUDA tile tried
        for t in outcome.trials:
            name = "x".join(map(str, evaluate.tile_for(t.config)))
            tiles[name] = min(t.cost, tiles.get(name, math.inf))
        measured = {**_card(evaluate), "measured_s": outcome.best_cost,
                    "tiles_s": tiles}

    # Modeled costs for the report are always cost-model numbers so the
    # tuned <= greedy contract is judged on one scale.
    greedy_cost = (outcome.baseline_cost if evaluate is cost_eval
                   else cost_eval(space.baseline()))
    tuned_cost = (outcome.best_cost if evaluate is cost_eval
                  else cost_eval(outcome.best_config))
    if tuned_cost > greedy_cost:      # measured winner may model worse
        outcome.best_config = space.baseline()
        tuned_cost = greedy_cost
        if measured:
            measured["measured_s"] = outcome.baseline_cost

    validation = None
    if validate:
        validation = validate_selection(
            case.proxy_original, case.proxy_selection, graph,
            ParamApproach(outcome.best_config), rng_seed=seed)

    key = tuning_key(case.program, graph, backend)
    return CaseReport(name=case.name, key=key, backend=backend,
                      greedy_cost=greedy_cost, tuned_cost=tuned_cost,
                      outcome=outcome, validation=validation,
                      elapsed_s=time.time() - t0,
                      config=dict(outcome.best_config),
                      counters=_case_counters(cost_eval), measured=measured)


def _case_counters(cost_eval: CostModelEvaluator) -> dict:
    """Per-case throughput counters for ``--json`` rows: the cost
    evaluator's ``EvalStats`` (evals, guard rejects, schedule-key memo hits,
    fresh vs incremental schedules, schedule wall time) and the resulting
    configs/sec over the evaluator's own wall time."""
    counters = cost_eval.stats.as_dict()
    wall = counters["schedule_s"] + counters["predict_s"]
    counters["configs_per_sec"] = (round(counters["evals"] / wall, 1)
                                   if wall > 0 else 0.0)
    return counters


def tune_fabric_case(m: int, n: int, k: int, topo, strategy: str,
                     trials: int, seed: int,
                     validate: bool = True) -> CaseReport:
    """Joint distributed tuning of one GEMM shape on one fabric: the config
    vector spans (partition axis, collective algorithm, per-chip tiles) and
    candidates are scored by the ``repro_torch.fabric`` simulator's
    distributed makespan.  Trial 0 is the untuned multi-chip baseline, so
    the tuned config is <= the untuned fabric default by construction."""
    from ..core.kernels_ir import matmul
    from ..fabric.partition import partition_gemm, replay_bitexact
    from ..fabric.simulate import VALIDATE_DIM_CAP as FAB_CAP
    from ..fabric.simulate import FabricEvaluator
    from ..fabric.topology import Topology

    t0 = time.time()
    space = SearchSpace.for_fabric("gemm")
    evaluate = FabricEvaluator("gemm", (m, n, k), topo)
    outcome = STRATEGIES[strategy](space, evaluate, trials=trials, seed=seed)

    validation = None
    if validate:
        pm, pn, pk = (max(topo.n_chips, min(d, FAB_CAP)) for d in (m, n, k))
        axis = outcome.best_config.get("part_axis", "m")
        proxy = partition_gemm(pm, pn, pk, axis, topo.n_chips)
        validation = replay_bitexact(proxy, Topology.chip_graph(),
                                     ParamApproach(outcome.best_config),
                                     rng_seed=seed)

    key = tuning_key(matmul(m, n, k), topo.build_graph(), "fabric")
    return CaseReport(name=f"fabric_gemm_{m}x{n}x{k}_{topo.name}", key=key,
                      backend="fabric",
                      greedy_cost=outcome.baseline_cost,
                      tuned_cost=outcome.best_cost,
                      outcome=outcome, validation=validation,
                      elapsed_s=time.time() - t0,
                      config=dict(outcome.best_config))


def fabric_record_for(report: CaseReport, topo, strategy: str) -> TuningRecord:
    return TuningRecord(
        key=report.key, config=report.config, cost=report.tuned_cost,
        baseline_cost=report.greedy_cost, backend="fabric",
        strategy=strategy, trials=report.outcome.evaluations,
        meta={"case": report.name, "topology": topo.name,
              "chips": topo.n_chips,
              "speedup": round(report.greedy_cost
                               / max(report.tuned_cost, 1e-30), 4)})


def record_for(case: TuneCase, report: CaseReport, graph: SystemGraph,
               strategy: str) -> TuningRecord:
    tile = None
    if case.gemm_shape is not None:
        tile = gemm_tile_for(report.config, graph, *case.gemm_shape)
    return TuningRecord(
        key=report.key, config=report.config, cost=report.tuned_cost,
        baseline_cost=report.greedy_cost, backend=report.backend,
        strategy=strategy,
        trials=report.outcome.evaluations, tile=tile,
        meta={"case": case.name, "graph": graph.name,
              "speedup": round(report.greedy_cost
                               / max(report.tuned_cost, 1e-30), 4),
              **report.measured})


def _tune_worker(payload: dict) -> tuple[int, CaseReport]:
    """One ``--workers`` subprocess unit: rebuild the case from the suite
    descriptor (programs/selections are cheap to rebuild and the descriptor
    is trivially picklable, unlike a live Selection closure) and tune it.
    Returns ``(case index, report)`` so the parent merges reports — and
    cache records — in deterministic case order regardless of which worker
    finishes first."""
    idx = payload["idx"]
    if payload["suite"] == "fabric":
        from ..fabric.topology import make_topology
        topo = make_topology(payload["topology"], payload["chips"])
        m, n, k = payload["shape"]
        return idx, tune_fabric_case(m, n, k, topo, payload["strategy"],
                                     payload["trials"], payload["seed"],
                                     validate=payload["validate"])
    case = build_cases(payload["suite"], payload["limit"])[idx]
    return idx, tune_case(case, make_graph(payload["graph"]),
                          payload["strategy"], payload["trials"],
                          payload["seed"], payload["backend"],
                          validate=payload["validate"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.search.tune",
        description="Joint mapping/schedule autotuner with persistent cache.")
    ap.add_argument("--suite", choices=["gemm", "gru", "fabric"],
                    default="gemm")
    ap.add_argument("--chips", type=int, default=4,
                    help="fabric suite: number of chips")
    ap.add_argument("--topology", choices=["ring", "torus", "host"],
                    default="ring", help="fabric suite: fabric shape")
    ap.add_argument("--trials", type=int, default=32)
    ap.add_argument("--strategy", choices=sorted(STRATEGIES),
                    default="hillclimb")
    ap.add_argument("--backend", choices=["cost", "measure"], default="cost",
                    help="'cost' scores the modeled schedule; 'measure' times "
                         "K1 on the CUDA card (needs one; GRU cases stay on "
                         "'cost')")
    ap.add_argument("--target", choices=list(GRAPH_NAMES), default="gpu_sm",
                    help="modeled hardware target to tune against")
    ap.add_argument("--cache", default=None,
                    help=f"cache path (default {default_cache_path()})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=1,
                    help="tune cases in N parallel processes (cost backend "
                         "only); per-case results are bit-identical to "
                         "--workers 1 and reports/cache records merge in "
                         "deterministic case order")
    ap.add_argument("--limit", type=int, default=None,
                    help="tune only the first N cases of the suite")
    ap.add_argument("--no-validate", action="store_true")
    ap.add_argument("--json", default=None, help="write the report here")
    args = ap.parse_args(argv)
    strategy = args.strategy

    if args.backend == "measure":
        if args.suite == "fabric":
            print("--suite fabric is scored by the fabric simulator: use "
                  "--backend cost", file=sys.stderr)
            return 2
        if args.workers > 1:
            print("--backend measure tunes one case at a time on the card "
                  "(--workers 1)", file=sys.stderr)
            return 2
        from ..kernels.cuda import resolve_device
        try:
            resolve_device()
        except RuntimeError as e:
            print(f"--backend measure: {e}", file=sys.stderr)
            return 2

    graph = make_graph(args.target)
    cache = TuningCache(args.cache)
    reports: list[CaseReport] = []

    if args.suite == "fabric":
        from ..fabric.topology import make_topology
        topo = make_topology(args.topology, args.chips)
        shapes = FABRIC_GEMM_SIZES[:args.limit] if args.limit \
            else FABRIC_GEMM_SIZES
        print(f"# tuning {len(shapes)} fabric case(s): chips={args.chips} "
              f"topology={topo.name} strategy={strategy} "
              f"trials={args.trials}")
        print(f"# cache: {cache.path}")
        runs = [lambda m=m, n=n, k=k: tune_fabric_case(
                    m, n, k, topo, strategy, args.trials, args.seed,
                    validate=not args.no_validate)
                for m, n, k in shapes]
        payloads = [{"idx": i, "suite": "fabric", "shape": shapes[i],
                     "topology": args.topology, "chips": args.chips,
                     "strategy": strategy, "trials": args.trials,
                     "seed": args.seed, "validate": not args.no_validate}
                    for i in range(len(shapes))]
        recorder = lambda rep: fabric_record_for(  # noqa: E731
            rep, topo, rep.outcome.strategy)
    else:
        cases = build_cases(args.suite, args.limit)
        if not cases:
            print("no cases selected", file=sys.stderr)
            return 2
        print(f"# tuning {len(cases)} case(s): suite={args.suite} "
              f"strategy={strategy} trials={args.trials} "
              f"backend={args.backend} graph={graph.name}")
        print(f"# cache: {cache.path}")
        by_name = {case.name: case for case in cases}
        runs = [lambda case=case: tune_case(
                    case, graph, strategy, args.trials, args.seed,
                    args.backend, validate=not args.no_validate)
                for case in cases]
        payloads = [{"idx": i, "suite": args.suite, "limit": args.limit,
                     "graph": args.target, "strategy": strategy,
                     "trials": args.trials, "seed": args.seed,
                     "backend": args.backend,
                     "validate": not args.no_validate}
                    for i in range(len(cases))]
        recorder = lambda rep: record_for(  # noqa: E731
            by_name[rep.name], rep, graph, rep.outcome.strategy)

    def emit(rep: CaseReport) -> None:
        reports.append(rep)
        cache.store(recorder(rep), save=False)
        v = rep.validation
        vtxt = ("-" if v is None else
                ("exact" if v.exact else f"err={v.max_abs_err:.2e}"))
        status = "ok" if rep.ok else "FAIL"
        measured = ("" if not rep.measured else
                    f" measured={rep.measured['measured_s']:.3e}s")
        print(f"[{status}] {rep.name}: greedy={rep.greedy_cost:.3e}s "
              f"tuned={rep.tuned_cost:.3e}s "
              f"speedup={rep.greedy_cost / max(rep.tuned_cost, 1e-30):.2f}x"
              f"{measured} oracle={vtxt} ({rep.outcome.evaluations} trials, "
              f"{rep.elapsed_s:.1f}s)", flush=True)

    if args.workers > 1:
        # Fan cases across processes; collect by index so reports and cache
        # records land in the same order a sequential run produces (the
        # cache file diffs empty against --workers 1).  Spawned workers
        # start from a fresh import: nothing of the parent's state is shared.
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        print(f"# workers: {args.workers}")
        with ProcessPoolExecutor(
                max_workers=args.workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            done = dict(ex.map(_tune_worker, payloads))
        for i in range(len(payloads)):
            emit(done[i])
    else:
        for run in runs:
            emit(run())
    failures = sum(1 for r in reports if not r.ok)
    cache.save()
    print(f"# wrote {len(reports)} record(s) to {cache.path}")

    if args.json:
        meta = {"schema": 1, "suite": args.suite,
                "strategy": strategy, "trials": args.trials,
                "backend": args.backend, "graph": graph.name,
                "cache": cache.path, "failures": failures}
        if args.suite == "fabric":
            meta["chips"] = args.chips
            meta["topology"] = args.topology
        with open(args.json, "w") as f:
            json.dump({**meta, "rows": [r.row() for r in reports]}, f,
                      indent=2)
        print(f"# report: {args.json}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
