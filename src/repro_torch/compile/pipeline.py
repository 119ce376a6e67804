"""The pass-based compilation pipeline.

``Pipeline(passes=(MapPass(), SelectPass(), SchedulePass(), LowerPass()))``
drives one ``CompileContext`` — an ISAMIR ``Program`` + ``SystemGraph`` +
``Approach`` — through the paper's stages:

    Program ──Map──▶ candidates ──Select──▶ Selection ──Schedule──▶
        Schedule ──Verify──▶ (statically checked) ──Lower──▶
        tile/grid plan + lowering config

and assembles the result into a ``CompiledKernel`` artifact.  Each pass is a
small object with ``run(ctx)``; custom pipelines can drop, replace or extend
passes (the driver uses a truncated Schedule+Lower pipeline when a selection
is already in hand).

Passes reuse the existing subsystem entry points (``core.isel``,
``core.scheduler``) — the pipeline adds *structure*, not a parallel
implementation, so a pipeline compile is bit-identical to the historical
ad-hoc call chains.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..core.approach import Approach, GreedyApproach
from ..core.ir import Program
from ..core.isel import (Selection, candidate_instructions,
                         select_from_candidates)
from ..core.scheduler import Schedule, ScheduleError, schedule
from ..core.sysgraph import SystemGraph
from .artifact import CompiledKernel, CompileError, InstrPlan
from .keys import (approach_fingerprint, artifact_key_from_parts,
                   isa_fingerprint, program_fingerprint, sysgraph_fingerprint)


@dataclass
class CompileContext:
    """Mutable state threaded through the passes."""

    program: Program
    graph: SystemGraph
    approach: Approach | None = None
    isa: list = field(default_factory=list)
    allow_transforms: bool = True
    backend: str = "cost"
    verify: bool = True
    meta: dict = field(default_factory=dict)

    # produced by passes
    candidates: list | None = None
    selection: Selection | None = None
    schedule: Schedule | None = None
    instr_plans: tuple[InstrPlan, ...] | None = None
    lowering: dict | None = None


class Pass:
    """One pipeline stage.  ``run`` mutates the context in place."""

    name = "pass"

    def run(self, ctx: CompileContext) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class MapPass(Pass):
    """Instruction mapping (paper Section 2.2): find every way each ISA
    needle identifies inside the program."""

    name = "map"

    def run(self, ctx: CompileContext) -> None:
        if not ctx.isa:
            raise CompileError("MapPass needs a non-empty ISA")
        ctx.candidates = candidate_instructions(ctx.program, ctx.isa)


class SelectPass(Pass):
    """Instruction selection (Section 2.4): cover the program from the
    mapping candidates, consulting the transform search when allowed."""

    name = "select"

    def run(self, ctx: CompileContext) -> None:
        if ctx.candidates is None:
            raise CompileError("SelectPass requires MapPass output")
        sel = select_from_candidates(ctx.program, ctx.candidates, ctx.isa,
                                     allow_transforms=ctx.allow_transforms,
                                     approach=ctx.approach)
        if not sel.complete:
            raise CompileError(
                f"program {ctx.program.name} not fully mappable: statements "
                f"{sel.uncovered} uncovered by {[n.name for n in ctx.isa]}")
        ctx.selection = sel


class SchedulePass(Pass):
    """Static dry-run scheduling (Section 3): unroll, allocate, move."""

    name = "schedule"

    def run(self, ctx: CompileContext) -> None:
        if ctx.selection is None:
            raise CompileError("SchedulePass requires a Selection")
        ctx.schedule = schedule(ctx.selection, ctx.graph, ctx.approach)


class VerifyPass(Pass):
    """Static analysis gate (``repro_torch.verify``): program legality,
    selection coverage/role consistency, and a symbolic hazard replay of the
    schedule.  Strict by default — any error-severity diagnostic aborts the
    compile with a ``CompileError``; set ``ctx.verify = False`` to skip."""

    name = "verify"

    def run(self, ctx: CompileContext) -> None:
        if not ctx.verify:
            return
        from ..verify import verify_compile
        report = verify_compile(selection=ctx.selection,
                                schedule=ctx.schedule,
                                approach=ctx.approach)
        if not report.ok:
            raise CompileError(
                f"static verification of {ctx.program.name} failed "
                f"({len(report.errors)} error(s)):\n{report.render()}")


class LowerPass(Pass):
    """Extract the role-keyed tile plan and the backend lowering config.

    Tile sizes are resolved through each mapping's ``axis_map`` (needle axis
    → haystack axis), *not* by guessing haystack axis names — the fix for
    the historical ``_tile_from_schedule`` i/j/k assumption.  Programs whose
    mapped axes don't appear in any compute tile raise ``CompileError``.
    """

    name = "lower"

    def run(self, ctx: CompileContext) -> None:
        sel, sched = ctx.selection, ctx.schedule
        if sel is None or sched is None:
            raise CompileError("LowerPass requires selection + schedule")
        prog = sel.program
        plans: list[InstrPlan] = []
        first_tile: dict[int, dict] = {}
        for op in sched.ops:
            if op.kind == "compute" and op.tile.instr_idx not in first_tile:
                first_tile[op.tile.instr_idx] = op.tile.sizes
        for idx, si in enumerate(sel.instrs):
            sizes = first_tile.get(idx)
            if sizes is None:
                raise CompileError(
                    f"schedule contains no compute tile for instruction "
                    f"{idx} ({si.needle.name})")
            tile = []
            for na, ha in si.mapping.axis_map:
                if ha not in sizes:
                    raise CompileError(
                        f"mapped axis {na}->{ha} of {si.needle.name} absent "
                        f"from its compute tiles (axes: {sorted(sizes)})")
                tile.append((na, int(sizes[ha])))
            plans.append(InstrPlan(
                needle=si.needle.name,
                axis_map=tuple(si.mapping.axis_map),
                tile=tuple(tile),
                outer_axes=tuple(si.mapping.outer_axes),
                calls=si.mapping.calls(prog)))
        ctx.instr_plans = tuple(plans)
        ctx.lowering = self._lowering(ctx, plans)

    @staticmethod
    def _lowering(ctx: CompileContext, plans: list[InstrPlan]) -> dict:
        """Backend config: a single full-cover matmul lowers to a blocked
        Pallas GEMM BlockSpec — ``pallas_gemm`` (TPU/paper: block sized for
        VMEM) or ``pallas_gpu_gemm`` (GPU family: block sized for the
        cluster's shared memory, with the staged panel bytes recorded so
        the artifact checker can audit the fit).  Everything else stays an
        executor-backed instruction stream."""
        sel = ctx.selection
        mm = [p for p in plans if p.needle.startswith("mxu.matmul")]
        if len(plans) == 1 and mm and not sel.steps:
            plan = mm[0]
            tiles = dict(plan.tile)
            amap = dict(plan.axis_map)
            try:
                extents = {na: sel.program.axis(amap[na]).size
                           for na in ("i", "j", "k")}
                block = tuple(min(tiles[na], extents[na])
                              for na in ("i", "j", "k"))
            except KeyError:
                return {"kind": "stream"}
            grid = tuple(math.ceil(extents[na] / b)
                         for na, b in zip(("i", "j", "k"), block))
            if getattr(ctx.graph, "family", "") == "gpu":
                # A (bm, bk) + B (bk, bn) panels plus the C (bm, bn)
                # accumulator tile staged in shared memory, f32 elements.
                bm, bn, bk = block[0], block[1], block[2]
                smem = 4 * (bm * bk + bk * bn + bm * bn)
                return {"kind": "pallas_gpu_gemm", "block": list(block),
                        "grid": list(grid), "smem_bytes": smem}
            return {"kind": "pallas_gemm", "block": list(block),
                    "grid": list(grid)}
        return {"kind": "stream"}


DEFAULT_PASSES = (MapPass(), SelectPass(), SchedulePass(), VerifyPass(),
                  LowerPass())


@dataclass
class Pipeline:
    """An ordered pass list + artifact assembly."""

    passes: tuple = DEFAULT_PASSES

    def run(self, ctx: CompileContext) -> CompiledKernel:
        approach = ctx.approach if ctx.approach is not None else GreedyApproach()
        ctx.approach = approach
        try:
            for p in self.passes:
                p.run(ctx)
        except ScheduleError as e:
            raise CompileError(str(e)) from e
        return self.assemble(ctx)

    @staticmethod
    def assemble(ctx: CompileContext) -> CompiledKernel:
        sched = ctx.schedule
        cost = sched.makespan if sched is not None else float("inf")
        prog_fp = program_fingerprint(ctx.program)
        graph_fp = sysgraph_fingerprint(ctx.graph)
        approach_fp = approach_fingerprint(ctx.approach)
        return CompiledKernel(
            key=artifact_key_from_parts(ctx.program.name, prog_fp,
                                        ctx.graph.name, graph_fp,
                                        approach_fp, ctx.backend,
                                        isa_fingerprint(ctx.isa),
                                        ctx.allow_transforms),
            program_name=ctx.program.name,
            program_fp=prog_fp,
            graph_name=ctx.graph.name,
            graph_fp=graph_fp,
            approach_fp=approach_fp,
            backend=ctx.backend,
            cost=cost,
            instrs=ctx.instr_plans or (),
            counts=sched.counts() if sched is not None else {},
            bytes_moved=sched.bytes_moved() if sched is not None else 0,
            lowering=ctx.lowering or {"kind": "stream"},
            meta=dict(ctx.meta),
            program=ctx.program, graph=ctx.graph, approach=ctx.approach,
            isa=list(ctx.isa), selection=ctx.selection, schedule=sched)
