"""The compilation driver: one entry point in front of the whole pipeline.

``compile_program`` is the general entry (any ISAMIR program, any system
graph, any Approach); ``compile_gemm`` / ``compile_gru`` are the workload
frontends the kernels, the tuner and the smoke run share;
``compile_selection`` runs the back half of the pipeline when an instruction
selection is already in hand (the search evaluators and per-chip fabric
compiles); ``compile_fabric`` partitions a workload across a multi-chip
topology and returns an artifact carrying the distributed plan; and
``DeltaScheduler`` re-schedules many approaches of one selection
incrementally.

Every entry produces (or replays) a ``CompiledKernel``.  Fresh compiles are
memoized in-process per artifact key; the persistent artifact cache is
consulted when one is passed explicitly or activated process-wide
(``repro_torch.compile.cache.set_default_artifact_cache``).  Every compile
but ``compile_selection`` runs the static verifier (``VerifyPass``) before
Lower by default.  The default target is the modeled GPU, ``gpu_sm(8)``.
"""
from __future__ import annotations

import copy

from ..core import instructions as I
from ..core import kernels_ir as K
from ..core.approach import Approach, CostModelApproach, GreedyApproach
from ..core.ir import Program
from ..core.isel import Selection
from ..core.sysgraph import SystemGraph, gpu_sm
from .artifact import CompiledKernel, CompileError
from .cache import ArtifactCache, get_default_artifact_cache
from .keys import (artifact_key, cacheable_approach, program_fingerprint,
                   sysgraph_fingerprint)
from .pipeline import (CompileContext, LowerPass, MapPass, Pipeline,
                       SchedulePass, SelectPass, VerifyPass)

#: In-process artifact memo: fresh compiles with a reproducible approach are
#: reused by key.
_MEMO: dict[str, CompiledKernel] = {}
_MEMO_CAP = 512


def clear_memo() -> None:
    _MEMO.clear()


def resolve_approach(approach) -> Approach:
    """Accept an Approach instance, ``None`` (greedy), or the historical
    string names (``'greedy'`` / ``'costmodel'``)."""
    if approach is None:
        return GreedyApproach()
    if isinstance(approach, str):
        if approach == "greedy":
            return GreedyApproach()
        if approach == "costmodel":
            return CostModelApproach(samples=4)
        raise ValueError(f"unknown approach name {approach!r}")
    return approach


# --------------------------------------------------------------------------- #
# Workload frontends
# --------------------------------------------------------------------------- #


def select_program(program: Program, isa=None, allow_transforms: bool = True,
                   approach=None, graph: SystemGraph | None = None
                   ) -> Selection:
    """Map + Select through the pipeline passes; raises ``CompileError`` if
    the program cannot be fully covered.  Map and Select never read the
    graph; it only completes the context."""
    ctx = CompileContext(program=program,
                         graph=graph if graph is not None else gpu_sm(8),
                         approach=approach,
                         isa=list(isa) if isa else I.tpu_isa(),
                         allow_transforms=allow_transforms)
    MapPass().run(ctx)
    SelectPass().run(ctx)
    return ctx.selection


def gemm_selection(m: int, n: int, k: int) -> tuple[Program, Selection]:
    """The canonical (m, n, k) GEMM against the MXU matmul needle."""
    prog = K.matmul(m, n, k)
    return prog, select_program(prog, [I.mxu_matmul()],
                                allow_transforms=False)


def gru_selection(batch: int, hidden: int,
                  inp: int | None = None) -> tuple[Program, Selection]:
    """The GRU cell against the full ISA (fused instructions in play)."""
    prog = K.gru_cell(batch, hidden, hidden if inp is None else inp)
    return prog, select_program(prog, I.tpu_isa())


_FRONTENDS = {
    "gemm": lambda **kw: gemm_selection(**kw),
    "gru": lambda **kw: gru_selection(**kw),
}


# --------------------------------------------------------------------------- #
# Core compiles
# --------------------------------------------------------------------------- #


def _resolve_cache(cache, use_cache: bool) -> ArtifactCache | None:
    if not use_cache:
        return None
    return cache if cache is not None else get_default_artifact_cache()


def _strip(art: CompiledKernel) -> CompiledKernel:
    """A detached copy holding only the serializable payload — what the memo
    keeps (and hands back) so it never pins live schedules/selections; a
    consumer that needs the schedule calls ``ensure_schedule()``."""
    s = copy.copy(art)
    s.program = s.graph = s.approach = s.isa = None
    s.selection = s.schedule = None
    s.meta = dict(art.meta)
    s.from_cache = True
    return s


def _store(art: CompiledKernel, cache: ArtifactCache | None,
           memoize: bool) -> CompiledKernel:
    """The one store/memo policy for every compile entry."""
    if cacheable_approach(art.approach):
        if cache is not None:
            cache.store(art)
        if memoize:
            if len(_MEMO) >= _MEMO_CAP:
                _MEMO.clear()
            _MEMO[art.key] = _strip(art)
    return art


def _finish(ctx: CompileContext, cache: ArtifactCache | None,
            memoize: bool) -> CompiledKernel:
    return _store(Pipeline(passes=(SchedulePass(), VerifyPass(),
                                   LowerPass())).run(ctx),
                  cache, memoize)


def _lookup(program: Program, graph: SystemGraph, approach, backend: str,
            cache: ArtifactCache | None, memoize: bool, isa=None,
            allow_transforms: bool = True):
    """(key, hit) — the memo is consulted first, then the persistent cache."""
    if not cacheable_approach(approach):
        return None, None
    key = artifact_key(program, graph, approach, backend, isa,
                       allow_transforms)
    if memoize and key in _MEMO:
        return key, _strip(_MEMO[key])
    if cache is not None:
        hit = cache.lookup(key)
        if hit is not None:
            return key, hit
    return key, None


def compile_program(program: Program, graph: SystemGraph | None = None,
                    approach=None, isa=None, *,
                    allow_transforms: bool = True, backend: str = "cost",
                    cache: ArtifactCache | None = None, use_cache: bool = True,
                    verify: bool = True,
                    meta: dict | None = None) -> CompiledKernel:
    """Program + SystemGraph + Approach -> CompiledKernel, through the full
    Map -> Select -> Schedule -> Verify -> Lower pipeline.  ``verify=False``
    skips the static verifier."""
    graph = graph if graph is not None else gpu_sm(8)
    approach = resolve_approach(approach)
    isa = list(isa) if isa else I.tpu_isa()
    cache = _resolve_cache(cache, use_cache)
    key, hit = _lookup(program, graph, approach, backend, cache, use_cache,
                       isa, allow_transforms)
    if hit is not None:
        _attach(hit, program, graph, approach, isa, allow_transforms)
        return hit
    ctx = CompileContext(program=program, graph=graph, approach=approach,
                         isa=isa, allow_transforms=allow_transforms,
                         backend=backend, verify=verify,
                         meta=dict(meta or {}))
    ctx.meta.setdefault("allow_transforms", allow_transforms)
    MapPass().run(ctx)
    SelectPass().run(ctx)
    return _finish(ctx, cache, memoize=use_cache)


def compile_selection(selection: Selection, graph: SystemGraph,
                      approach=None, *, backend: str = "cost",
                      program: Program | None = None,
                      verify: bool = False,
                      meta: dict | None = None) -> CompiledKernel:
    """Schedule + Lower an existing Selection (no caching: this is the hot
    inner entry the search evaluators and per-chip fabric compiles use, so
    the static verifier is opt-in here — pass ``verify=True`` to gate)."""
    approach = resolve_approach(approach)
    ctx = CompileContext(program=program or selection.program, graph=graph,
                         approach=approach, backend=backend,
                         meta=dict(meta or {}))
    ctx.selection = selection
    passes = ((SchedulePass(), VerifyPass(), LowerPass()) if verify
              else (SchedulePass(), LowerPass()))
    return Pipeline(passes=passes).run(ctx)


def _compile_frontend(frontend: str, fe_args: dict, graph, approach, backend,
                      cache, use_cache, verify: bool = True) -> CompiledKernel:
    graph = graph if graph is not None else gpu_sm(8)
    approach = resolve_approach(approach)
    cache = _resolve_cache(cache, use_cache)
    # Frontend programs are cheap to rebuild; selections are not — key off
    # the program (+ the frontend's ISA/transform policy), select on a miss.
    program, isa, allow_transforms, _sel_builder = \
        _frontend_program(frontend, fe_args, graph)
    key, hit = _lookup(program, graph, approach, backend, cache, use_cache,
                       isa, allow_transforms)
    if hit is not None:
        _attach(hit, program, graph, approach, isa, allow_transforms)
        hit.meta.setdefault("frontend", frontend)
        hit.meta.setdefault("frontend_args", dict(fe_args))
        return hit
    ctx = CompileContext(program=program, graph=graph, approach=approach,
                         isa=isa, allow_transforms=allow_transforms,
                         backend=backend, verify=verify,
                         meta={"frontend": frontend,
                               "frontend_args": dict(fe_args)})
    ctx.selection = _sel_builder()
    return _finish(ctx, cache, memoize=use_cache)


def _frontend_program(frontend: str, fe_args: dict, graph: SystemGraph):
    """(program, isa, allow_transforms, lazy selection builder) for one
    workload frontend — lets a cache hit skip the (expensive) mapping +
    selection entirely while keying on the exact compile inputs."""
    if frontend == "gemm":
        prog = K.matmul(fe_args["m"], fe_args["n"], fe_args["k"])
        isa = [I.mxu_matmul()]
        return prog, isa, False, lambda: select_program(
            prog, isa, allow_transforms=False, graph=graph)
    if frontend == "gru":
        inp = fe_args.get("inp")
        prog = K.gru_cell(fe_args["batch"], fe_args["hidden"],
                          fe_args["hidden"] if inp is None else inp)
        isa = I.tpu_isa()
        return prog, isa, True, lambda: select_program(prog, isa,
                                                       graph=graph)
    raise CompileError(f"unknown frontend {frontend!r}")


def compile_gemm(m: int, n: int, k: int, approach=None,
                 graph: SystemGraph | None = None, *,
                 backend: str = "cost", cache: ArtifactCache | None = None,
                 use_cache: bool = True, verify: bool = True) -> CompiledKernel:
    return _compile_frontend("gemm", {"m": m, "n": n, "k": k}, graph,
                             approach, backend, cache, use_cache, verify)


def compile_gru(batch: int, hidden: int, inp: int | None = None,
                approach=None, graph: SystemGraph | None = None, *,
                backend: str = "cost", cache: ArtifactCache | None = None,
                use_cache: bool = True, verify: bool = True) -> CompiledKernel:
    fe_args = {"batch": batch, "hidden": hidden}
    if inp is not None:
        fe_args["inp"] = inp
    return _compile_frontend("gru", fe_args, graph, approach, backend,
                             cache, use_cache, verify)


# --------------------------------------------------------------------------- #
# Multi-chip (fabric) compiles
# --------------------------------------------------------------------------- #


def compile_fabric(kernel: str, shape: tuple[int, ...], topo,
                   axis: str | None = None, approach=None,
                   algorithm: str = "ring", replicate_out: bool = False, *,
                   cache: ArtifactCache | None = None,
                   use_cache: bool = True) -> CompiledKernel:
    """Partition ``kernel``/``shape`` across ``topo`` and compile: per-chip
    schedules come from ``compile_selection`` and the distributed makespan
    from the ``repro_torch.fabric`` event simulator.  The artifact's tile
    plan is chip 0's; ``artifact.fabric`` carries the partition + collective
    plan."""
    from ..fabric.partition import partition, partition_axes
    from ..fabric.simulate import replicate_output, simulate_partition
    from ..fabric.topology import Topology

    approach = resolve_approach(approach)
    axis = axis or partition_axes(kernel)[0]
    backend = (f"fabric-{topo.name}-{axis}-{algorithm}"
               + ("-repl" if replicate_out else ""))
    cache = _resolve_cache(cache, use_cache)
    chip_graph = Topology.chip_graph()
    fabric_graph = topo.build_graph()
    pp = partition(kernel, shape, axis, topo.n_chips)
    if replicate_out:
        pp = replicate_output(pp)

    key, hit = _lookup(pp.base, fabric_graph, approach, backend, cache,
                       use_cache)
    if hit is not None:
        _attach(hit, pp.base, fabric_graph, approach, None, True)
        return hit
    if key is None:                        # opaque approach: key is informational
        key = artifact_key(pp.base, fabric_graph, approach, backend)

    res = simulate_partition(pp, topo, approach, algorithm, chip_graph)
    shard0 = compile_selection(pp.shard_selection(pp.shards[0]), chip_graph,
                               approach, program=pp.shards[0].program)
    art = CompiledKernel(
        key=key,
        program_name=pp.base.name,
        program_fp=program_fingerprint(pp.base),
        graph_name=fabric_graph.name,
        graph_fp=sysgraph_fingerprint(fabric_graph),
        approach_fp=shard0.approach_fp,
        backend=backend,
        cost=res.makespan,
        instrs=shard0.instrs,
        counts=shard0.counts,
        bytes_moved=shard0.bytes_moved,
        lowering=shard0.lowering,
        fabric={"axis": pp.axis, "algorithm": res.algorithm,
                "chips": topo.n_chips, "topology": topo.name,
                "makespan": res.makespan, "comm_end": res.comm_end,
                "comm_bound": res.comm_bound,
                "collective_steps": res.n_collective_steps,
                "chip_spans": list(res.chip_spans),
                "out_mode": pp.out_mode,
                "collectives": [{"kind": c.kind, "buffer": c.buffer,
                                 "when": c.when, "axis": c.axis}
                                for c in pp.collectives],
                "per_chip_cost": shard0.cost},
        meta={"kernel": kernel, "shape": list(shape)},
        program=pp.base, graph=fabric_graph, approach=approach,
        selection=shard0.selection, schedule=shard0.schedule)
    return _store(art, cache, memoize=use_cache)


# --------------------------------------------------------------------------- #
# Cache-hit replay
# --------------------------------------------------------------------------- #


def _attach(art: CompiledKernel, program, graph, approach, isa,
            allow_transforms: bool) -> None:
    art.program = program
    art.graph = graph
    art.approach = approach
    art.isa = list(isa) if isa else None
    art.meta.setdefault("allow_transforms", allow_transforms)


def recompile_schedule(art: CompiledKernel) -> None:
    """Rebuild selection + schedule for a cache-hydrated artifact (used by
    ``CompiledKernel.ensure_schedule``).  Deterministic: the same program,
    graph and approach reproduce the cached decisions exactly.

    Fabric artifacts carry chip 0's *per-chip* schedule (what a fresh
    ``compile_fabric`` attaches), so the rebuild re-partitions and
    schedules shard 0 on the single-chip graph — not the unsharded program
    on the fabric graph."""
    if art.fabric is not None:
        from ..fabric.partition import partition
        from ..fabric.topology import Topology
        pp = partition(art.meta["kernel"], tuple(art.meta["shape"]),
                       art.fabric["axis"], art.fabric["chips"])
        shard0 = compile_selection(pp.shard_selection(pp.shards[0]),
                                   Topology.chip_graph(), art.approach,
                                   program=pp.shards[0].program)
        art.selection = shard0.selection
        art.schedule = shard0.schedule
        return
    if art.selection is None:
        fe = art.meta.get("frontend")
        if fe in _FRONTENDS:
            _, art.selection = _FRONTENDS[fe](**art.meta.get(
                "frontend_args", {}))
        else:
            art.selection = select_program(
                art.program, art.isa,
                allow_transforms=bool(art.meta.get("allow_transforms", True)),
                graph=art.graph)
    ctx = CompileContext(program=art.program, graph=art.graph,
                         approach=art.approach, backend=art.backend)
    ctx.selection = art.selection
    SchedulePass().run(ctx)
    art.schedule = ctx.schedule


# --------------------------------------------------------------------------- #
# Incremental re-scheduling across a config population
# --------------------------------------------------------------------------- #


class DeltaScheduler:
    """Schedules many Approach variants of one fixed Selection, reusing the
    unchanged per-instruction prefix of previously scheduled *anchors*.

    An anchor is a fully scheduled config kept with its per-instruction
    resume points (``core.scheduler.schedule_with_segments``).  A new key
    whose policy triple matches an anchor and whose per-instr tiles share a
    non-empty prefix resumes from the deepest snapshot before the first
    changed instruction (``schedule_incremental``) — verified bit-equal to
    the from-scratch schedule (``tests/test_torch_search.py`` holds the
    port's scores to the scalar path).  Keys come from
    ``repro_torch.search.batch.BatchPlan.analyze``.
    """

    def __init__(self, selection: Selection, graph: SystemGraph,
                 max_anchors: int = 8):
        from ..core.scheduler import schedule_incremental, \
            schedule_with_segments
        self.sel = selection
        self.graph = graph
        self.max_anchors = max_anchors
        self._full = schedule_with_segments
        self._inc = schedule_incremental
        #: (key, schedule, segments) of fresh runs, FIFO-trimmed
        self.anchors: list[tuple] = []
        self.stats = {"fresh": 0, "delta": 0}

    def schedule_for(self, approach: Approach, key: tuple):
        """The schedule for ``approach`` (whose BatchPlan key is ``key``),
        via the deepest-prefix anchor when one applies."""
        tiles, pol = key[0], key[1:]
        best = None                     # (first_changed, schedule, segments)
        for a_key, a_sched, a_segs in self.anchors:
            if a_key[1:] != pol:
                continue
            n = 0
            for ta, tb in zip(a_key[0], tiles):
                if ta != tb:
                    break
                n += 1
            # a resume needs the snapshot taken after instr n-1
            if n >= 1 and (n - 1) in a_segs \
                    and (best is None or n > best[0]):
                best = (n, a_sched, a_segs)
        if best is not None and best[0] < len(tiles):
            sched, _ = self._inc(self.sel, self.graph, approach,
                                 best[1], best[2], best[0])
            self.stats["delta"] += 1
            return sched
        sched, segs = self._full(self.sel, self.graph, approach)
        self.stats["fresh"] += 1
        self.anchors.append((key, sched, segs))
        if len(self.anchors) > self.max_anchors:
            self.anchors.pop(0)
        return sched
