"""Candidate evaluation backends + oracle validation (paper Section 4).

Three ways to score a config vector:

  * ``CostModelEvaluator`` — the fast path: compile the candidate
    ParamApproach through the ``repro_torch.compile`` driver (Schedule +
    Lower on the fixed Selection) and score the resulting
    ``CompiledKernel``'s modeled makespan.  A cheap tile-count pre-check
    rejects degenerate configs (tiny tiles on huge extents explode the
    simulated stream) with ``inf`` instead of minutes of scheduling.

  * ``LearnedEvaluator`` — the *surrogate* path: score by the trained ridge
    model of ``repro_torch.search.model`` (microseconds per candidate, no
    scheduling).  Used to rank large pools; real budgets still settle the
    winner, so the tuned <= greedy contract never rests on a prediction.

  * ``MeasuredGemmEvaluator`` — wall-clock on the card: the candidate's
    block (``gemm_tile_for``) becomes a CUDA tile (``kernels.gemm.block_tile``)
    and K1 (``csrc/gemm.cu``) is timed with CUDA events.  It needs a CUDA
    device and raises without one; a kernel error propagates.

``validate_selection`` replays a schedule through ``core.executor`` against
the ``ir.interpret`` oracle.  Because every unroll policy in the search
space keeps reduction offsets ascending per output region and all backends
accumulate in f64, a correct schedule replays **bit-exact** — the validation
reports exactness, not just closeness.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np

from ..compile import CompiledKernel, CompileError, compile_selection
from ..core.approach import Approach
from ..core.executor import execute
from ..core.instructions import is_elementwise
from ..core.ir import Program, interpret, random_inputs
from ..core.isel import Selection
from ..core.scheduler import Schedule
from ..core.sysgraph import SystemGraph
from .space import Config, ParamApproach


# --------------------------------------------------------------------------- #
# Cost-model backend
# --------------------------------------------------------------------------- #


@dataclass
class EvalStats:
    """Throughput counters one evaluator accumulates across a search (the
    ``tune --json`` per-case counters and the ``bench_search`` lanes)."""

    evals: int = 0           # configs scored (scalar + batch)
    guard_rejects: int = 0   # rejected by the tile-count guard (inf)
    memo_hits: int = 0       # scored via the schedule-key memo (no schedule)
    fresh: int = 0           # from-scratch schedules
    delta: int = 0           # incremental (anchor-resumed) schedules
    schedule_s: float = 0.0  # wall time in guard + scheduling
    predict_s: float = 0.0   # wall time in learned prediction

    def as_dict(self) -> dict:
        return {"evals": self.evals, "guard_rejects": self.guard_rejects,
                "memo_hits": self.memo_hits, "fresh": self.fresh,
                "delta": self.delta,
                "schedule_s": round(self.schedule_s, 6),
                "predict_s": round(self.predict_s, 6)}


class CostModelEvaluator:
    """Score a config by the modeled makespan of its ``CompiledKernel``.

    ``evaluate_many`` is the throughput tier: the feasibility guard runs
    vectorized over the whole population (``repro_torch.search.batch``), configs
    that alias to the same schedule key are scored once, and fresh keys go
    through the incremental ``DeltaScheduler`` so local-walk neighbors reuse
    the parent schedule's unchanged instruction prefix.  Scores are
    bit-identical to the scalar ``__call__`` path on every config.
    """

    def __init__(self, selection: Selection, graph: SystemGraph,
                 max_tiles: int = 4096, incremental: bool = True):
        self.sel = selection
        self.graph = graph
        self.max_tiles = max_tiles
        self.incremental = incremental
        self.stats = EvalStats()
        self._plan = None
        self._delta = None
        self._memo: dict[tuple, float] = {}

    @property
    def plan(self):
        """Lazy ``BatchPlan`` (selection-static guard/key analysis)."""
        if self._plan is None:
            from .batch import BatchPlan
            self._plan = BatchPlan(self.sel, self.graph)
        return self._plan

    def evaluate_many(self, configs) -> list[float]:
        """Population scoring: one vectorized guard pass, one schedule per
        *distinct schedule key* (memoized), incremental re-scheduling for
        keys sharing an instruction prefix with a scheduled anchor."""
        configs = list(configs)
        if not configs:
            return []
        t0 = time.perf_counter()
        feasible, keys = self.plan.analyze(configs, self.max_tiles)
        out: list[float] = []
        for cfg, ok, key in zip(configs, feasible, keys):
            self.stats.evals += 1
            if not ok:
                self.stats.guard_rejects += 1
                out.append(float("inf"))
                continue
            cost = self._memo.get(key)
            if cost is None:
                cost = self._schedule_cost(key, cfg)
                self._memo[key] = cost
            else:
                self.stats.memo_hits += 1
            out.append(cost)
        self.stats.schedule_s += time.perf_counter() - t0
        return out

    def _schedule_cost(self, key: tuple, config: Config) -> float:
        """Modeled makespan for one distinct schedule key (== the cost
        ``compile(config).cost`` would report: Pipeline.assemble sets the
        artifact cost to the schedule makespan)."""
        from ..core.scheduler import ScheduleError, schedule
        if self.plan.unschedulable:
            return float("inf")     # some instr has no device: compile fails
        approach = ParamApproach(config)
        try:
            if self.incremental:
                if self._delta is None:
                    from ..compile.driver import DeltaScheduler
                    self._delta = DeltaScheduler(self.sel, self.graph)
                sched = self._delta.schedule_for(approach, key)
                self.stats.fresh = self._delta.stats["fresh"]
                self.stats.delta = self._delta.stats["delta"]
            else:
                sched = schedule(self.sel, self.graph, approach)
                self.stats.fresh += 1
            return float(sched.makespan)
        except (CompileError, ScheduleError):
            return float("inf")

    def estimated_tiles(self, approach: Approach) -> int:
        """Upper-bound the compute-tile count the scheduler would unroll,
        using only the approach's tile request (no scheduling).  Elementwise
        needles coalesce their outer axes, so they count one call."""
        prog = self.sel.program
        total = 0
        for si in self.sel.instrs:
            devices = self.graph.compute_nodes_for(si.needle.name)
            if not devices:
                continue
            hw_tile = devices[0].matmul_tile
            extents = {na: prog.axis(ha).size
                       for na, ha in si.mapping.axis_map}
            req = approach.choose_tile_shape(
                si.needle.name, extents, hw_tile,
                vmem_budget=self.graph.staging_budget(devices))
            mapped = 1
            for na, ext in extents.items():
                mapped *= math.ceil(ext / max(1, min(req.get(na, ext), ext)))
            calls = 1 if is_elementwise(si.needle.name) \
                else si.mapping.calls(prog)
            total += mapped * calls
        return total

    def compile(self, config: Config) -> CompiledKernel:
        """The candidate's ``CompiledKernel`` (Schedule + Lower through the
        ``repro_torch.compile`` driver on this evaluator's fixed Selection)."""
        return compile_selection(self.sel, self.graph, ParamApproach(config))

    def schedule_config(self, config: Config) -> Schedule:
        return self.compile(config).schedule

    def __call__(self, config: Config) -> float:
        t0 = time.perf_counter()
        self.stats.evals += 1
        try:
            approach = ParamApproach(config)
            if self.estimated_tiles(approach) > self.max_tiles:
                self.stats.guard_rejects += 1
                return float("inf")
            try:
                cost = self.compile(config).cost
            except CompileError:
                return float("inf")
            self.stats.fresh += 1
            return cost
        finally:
            self.stats.schedule_s += time.perf_counter() - t0


class LearnedEvaluator:
    """Score a config by the **learned** cost model's prediction — no
    scheduling, no compile; microseconds per candidate.

    This is the ranking half of surrogate-guided search: predictions order a
    large pool, and the real trial budget (``CostModelEvaluator`` /
    measured) is reserved for the top of that order.  The evaluator keeps
    the analytical tile-count guard so degenerate configs stay ``inf`` —
    the model never trains on infeasible points, so it has no basis to
    reject them itself.

    ``for_selection`` resolves the model from a ``ModelStore`` (default:
    the process-wide store) and returns ``None`` when no model covers the
    program's family on this graph — callers fall back to the cost backend.
    """

    def __init__(self, model, selection: Selection, graph: SystemGraph,
                 max_tiles: int = 4096):
        self.model = model
        self.sel = selection
        self.graph = graph
        from ..compile.features import role_extents
        self._guard = CostModelEvaluator(selection, graph,
                                         max_tiles=max_tiles)
        self._predict = model.predictor(selection.program, graph,
                                        role_extents(selection))
        self.stats = self._guard.stats
        #: config key -> guard verdict.  Surrogate search scores the same
        #: configs repeatedly (pool ranking, then the neighbor walk, then
        #: the final sweep); without the memo every ranking pays the
        #: tile-count guard again for every config it has already screened.
        self._feas: dict[tuple, bool] = {}

    @classmethod
    def for_selection(cls, selection: Selection, graph: SystemGraph,
                      store=None, backend: str = "cost"
                      ) -> "LearnedEvaluator | None":
        from .model import get_default_store
        store = store if store is not None else get_default_store()
        if store is None:
            return None
        model = store.model_for(selection.program, graph, backend)
        if model is None:
            return None
        return cls(model, selection, graph)

    @property
    def predictor(self):
        """The raw (unguarded) ``config -> predicted seconds`` closure with
        ``predict_many`` — for diagnostics like ``model.topk_regret`` that
        score pre-screened configs.  Rankings that *choose* what to spend
        real budget on must go through the evaluator itself (``__call__`` /
        ``predict_many``), which keeps the tile-count guard."""
        return self._predict

    @property
    def anchors(self) -> list[Config]:
        """The cache-winner configs the model was trained on (its program
        family's "known good" set) — surrogate search seeds."""
        return [dict(c) for c in self.model.meta.get("anchors", [])]

    def _feasible(self, config: Config) -> bool:
        from .space import config_key
        k = config_key(config)
        got = self._feas.get(k)
        if got is None:
            got = self._feas[k] = bool(
                self._guard.estimated_tiles(ParamApproach(config))
                <= self._guard.max_tiles)
        return got

    def _feasible_many(self, configs: list) -> list[bool]:
        """Memoized batch guard: unseen configs go through the vectorized
        ``BatchPlan`` guard in one pass; seen configs are dict lookups."""
        from .space import config_key
        keys = [config_key(c) for c in configs]
        todo = [(c, k) for c, k in zip(configs, keys) if k not in self._feas]
        if todo:
            feas, _ = self._guard.plan.analyze([c for c, _ in todo],
                                               self._guard.max_tiles)
            for (_, k), ok in zip(todo, feas):
                self._feas[k] = bool(ok)
        return [self._feas[k] for k in keys]

    def predict_many(self, configs) -> list[float]:
        """Guarded batch prediction: infeasible configs score ``inf`` so a
        pool ranking can never put them in front of real-budget trials."""
        configs = list(configs)
        t0 = time.perf_counter()
        scores = self._predict.predict_many(configs)
        self.stats.predict_s += time.perf_counter() - t0
        self.stats.evals += len(configs)
        feasible = self._feasible_many(configs)
        self.stats.guard_rejects += sum(1 for ok in feasible if not ok)
        return [float(s) if ok else float("inf")
                for ok, s in zip(feasible, scores)]

    def __call__(self, config: Config) -> float:
        self.stats.evals += 1
        if not self._feasible(config):
            self.stats.guard_rejects += 1
            return float("inf")
        t0 = time.perf_counter()
        try:
            return self._predict(config)
        finally:
            self.stats.predict_s += time.perf_counter() - t0


def gemm_tile_for(config: Config, graph: SystemGraph,
                  m: int, n: int, k: int) -> tuple[int, int, int]:
    """The (bm, bn, bk) tile a config implies for an (m, n, k) GEMM on
    ``graph`` — the same hw-tile + staging-budget inputs the scheduler hands
    ``choose_tile_shape`` (``SystemGraph.staging_budget``), clamped to the
    problem.  One definition shared by the tuner's cache records, the
    measured backend, and the examples."""
    devices = graph.compute_nodes_for("mxu.matmul")
    if devices:
        hw_tile = min(d.matmul_tile for d in devices)
        vmem = graph.staging_budget(devices)
    else:   # pragma: no cover - graph without an MXU
        hw_tile, vmem = (128, 128, 128), None
    from .cache import clamp_tile
    req = ParamApproach(config).choose_tile_shape(
        "mxu.matmul", {"i": m, "j": n, "k": k}, hw_tile, vmem_budget=vmem)
    return clamp_tile((req["i"], req["j"], req["k"]), m, n, k)


# --------------------------------------------------------------------------- #
# Measured (CUDA wall-clock) backend
# --------------------------------------------------------------------------- #


class MeasuredGemmEvaluator:
    """Score a config by timing K1 on the card at the candidate's tile.

    The candidate's block is ``gemm_tile_for`` (the compiler's cluster
    block, as the cost backend and the cache records see it), launched as
    one CUDA block's tile through ``kernels.gemm.block_tile`` — the mapping
    ``ops.launch_config`` uses.  Inputs are f32 uniform(-1, 1) from a
    generator seeded with ``seed``.  A score is one warm-up launch, then the
    best of ``repeats`` single launches, each timed by a pair of CUDA events,
    in seconds.

    No fallback: a ``device`` that is not CUDA (default: the card, which
    must exist) raises here, and a kernel error propagates from
    ``__call__``."""

    def __init__(self, m: int, n: int, k: int, graph: SystemGraph,
                 repeats: int = 3, device=None, seed: int = 0):
        import torch

        from ..kernels.cuda import resolve_device
        from ..kernels.gemm import gemm
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"the measured backend times K1 on a CUDA "
                             f"device, not {dev}")
        self._torch = torch
        self._gemm = gemm
        self.m, self.n, self.k = m, n, k
        self.graph = graph
        self.repeats = repeats
        self.device = dev
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.a = torch.rand((m, k), generator=gen, device=dev) * 2 - 1
        self.b = torch.rand((k, n), generator=gen, device=dev) * 2 - 1

    def block_for(self, config: Config) -> tuple[int, int, int]:
        """The candidate's (bm, bn, bk) — the scheduler tile choice, clamped
        to the problem."""
        return gemm_tile_for(config, self.graph, self.m, self.n, self.k)

    def tile_for(self, config: Config) -> tuple[int, int, int]:
        """The CUDA tile K1 is launched with for the candidate (f32: the
        simt route)."""
        from ..kernels.gemm import block_tile
        return block_tile(self.block_for(config))

    def __call__(self, config: Config) -> float:
        torch = self._torch
        tile = self.tile_for(config)
        with torch.cuda.device(self.device):
            self._gemm(self.a, self.b, tile=tile)        # warm-up
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            best = float("inf")
            for _ in range(self.repeats):
                start.record()
                self._gemm(self.a, self.b, tile=tile)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) * 1e-3)
        return best


# --------------------------------------------------------------------------- #
# Oracle validation
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ValidationReport:
    exact: bool                 # bit-exact vs the ISAMIR oracle
    max_abs_err: float
    outputs: tuple[str, ...]

    @property
    def ok(self) -> bool:
        """Exact, or within float32 round-off of the f64 oracle."""
        return self.exact or self.max_abs_err < 1e-5


def validate_selection(prog: Program, selection: Selection,
                       graph: SystemGraph, approach: Approach,
                       rng_seed: int = 0) -> ValidationReport:
    """Compile ``selection`` with ``approach`` through the driver, execute
    the recorded stream with real data (core.executor) and compare against
    ``ir.interpret`` on the *original* program ``prog`` (transform steps
    adapted)."""
    art = compile_selection(selection, graph, approach, program=prog)
    return validate_schedule(prog, selection, art.schedule, rng_seed=rng_seed)


def validate_schedule(prog: Program, selection: Selection, sched: Schedule,
                      rng_seed: int = 0) -> ValidationReport:
    rng = np.random.default_rng(rng_seed)
    ins = random_inputs(prog, rng)
    ref = interpret(prog, ins)
    ins2 = ins
    for t in selection.steps:
        ins2 = t.adapt_inputs(ins2)
    got = execute(sched, selection, ins2)
    outs = {k: got[k] for k in ref}
    for t in reversed(selection.steps):
        outs = t.adapt_outputs(outs)
    exact = True
    max_err = 0.0
    for k in ref:
        got_k = np.asarray(outs[k])
        if got_k.shape != ref[k].shape and got_k.size == ref[k].size:
            # FuseAxes.adapt_outputs leaves the un-merge to the caller
            got_k = got_k.reshape(ref[k].shape)
        outs[k] = got_k
        if not np.array_equal(outs[k], ref[k]):
            exact = False
        diff = np.abs(np.asarray(outs[k], np.float64)
                      - np.asarray(ref[k], np.float64))
        if diff.size:
            max_err = max(max_err, float(diff.max()))
    return ValidationReport(exact=exact, max_abs_err=max_err,
                            outputs=tuple(ref))
