"""The ``CompiledKernel`` artifact — what the compilation driver produces.

One artifact captures everything the pipeline decided for a (program, system
graph, approach) triple:

  * the per-instruction **tile plan**, keyed by *mapped axis roles*: each
    selected instruction records its needle→haystack ``axis_map`` and the
    tile size the scheduler settled on per *needle* axis.  Consumers ask for
    roles (``i``/``j``/``k`` of ``mxu.matmul``) instead of guessing haystack
    axis names, so conv-extraction programs with fused axis names resolve
    exactly like plain GEMMs;
  * the **lowering config** — for matmul-shaped programs, the Pallas
    BlockSpec block + grid the kernels use; otherwise the generic
    instruction-stream marker;
  * the modeled **cost** (static-scheduler makespan) plus op counts and
    bytes moved;
  * for multi-chip compiles, the **fabric plan**: partition axis, collective
    specs, algorithm, per-chip tiles and the simulated distributed makespan.

Artifacts serialize to plain JSON dicts (``to_dict``/``from_dict``) so the
persistent artifact cache can replay a compile across processes.  Live
compiles additionally attach the in-memory ``selection``/``schedule``;
cache-hydrated artifacts rebuild them on demand via ``ensure_schedule()``
(deterministic: same program, graph and approach ⇒ the same schedule).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

ARTIFACT_SCHEMA = 1


class CompileError(RuntimeError):
    """A pipeline pass could not produce its required result."""


@dataclass(frozen=True)
class InstrPlan:
    """The tile decision for one selected instruction, keyed by axis role.

    ``axis_map`` maps needle (role) axes to haystack axes; ``tile`` holds the
    scheduler's chosen tile extent per *needle* axis.  ``outer_axes`` are the
    unmapped haystack axes the instruction is re-invoked over.
    """

    needle: str
    axis_map: tuple[tuple[str, str], ...]      # (needle axis, haystack axis)
    tile: tuple[tuple[str, int], ...]          # (needle axis, tile size)
    outer_axes: tuple[str, ...]
    calls: int

    def tile_for(self, role: str) -> int:
        for axis, size in self.tile:
            if axis == role:
                return size
        raise CompileError(
            f"instruction {self.needle} has no mapped axis for role "
            f"{role!r} (mapped roles: {[a for a, _ in self.tile]})")

    def to_dict(self) -> dict:
        return {"needle": self.needle,
                "axis_map": [list(p) for p in self.axis_map],
                "tile": [list(p) for p in self.tile],
                "outer_axes": list(self.outer_axes),
                "calls": self.calls}

    @classmethod
    def from_dict(cls, d: dict) -> "InstrPlan":
        return cls(needle=d["needle"],
                   axis_map=tuple((a, h) for a, h in d.get("axis_map", [])),
                   tile=tuple((a, int(s)) for a, s in d.get("tile", [])),
                   outer_axes=tuple(d.get("outer_axes", [])),
                   calls=int(d.get("calls", 1)))


@dataclass
class CompiledKernel:
    """Serializable result of one trip through the compilation pipeline."""

    key: str                          # artifact-cache key
    program_name: str
    program_fp: str
    graph_name: str
    graph_fp: str
    approach_fp: str
    backend: str
    cost: float                       # modeled makespan (seconds)
    instrs: tuple[InstrPlan, ...]
    counts: dict = field(default_factory=dict)
    bytes_moved: int = 0
    lowering: dict = field(default_factory=dict)
    fabric: dict | None = None
    meta: dict = field(default_factory=dict)
    from_cache: bool = False

    # live (non-serialized) attachments — present on fresh compiles, rebuilt
    # lazily on cache hits
    program: Any = field(default=None, repr=False, compare=False)
    graph: Any = field(default=None, repr=False, compare=False)
    approach: Any = field(default=None, repr=False, compare=False)
    isa: Any = field(default=None, repr=False, compare=False)
    selection: Any = field(default=None, repr=False, compare=False)
    schedule: Any = field(default=None, repr=False, compare=False)

    # -- the role-keyed tile plan -------------------------------------------
    def instr_plan(self, needle_prefix: str) -> InstrPlan:
        for p in self.instrs:
            if p.needle.startswith(needle_prefix):
                return p
        raise CompileError(
            f"no selected instruction matches {needle_prefix!r} "
            f"(have: {[p.needle for p in self.instrs]})")

    def gemm_tile(self) -> tuple[int, int, int]:
        """The (bm, bn, bk) tile of the matmul instruction, derived from the
        mapping's axis roles — raises ``CompileError`` on programs with no
        matmul-mapped instruction or with an incomplete role map."""
        plan = self.instr_plan("mxu.matmul")
        return (plan.tile_for("i"), plan.tile_for("j"), plan.tile_for("k"))

    # -- lazy schedule rebuild ----------------------------------------------
    def ensure_schedule(self):
        """Materialize the selection/schedule for this artifact.  Fresh
        compiles carry them already; cache-hydrated artifacts re-run the
        (deterministic) pipeline from the attached program/graph/approach
        (no graph: the default target, built on demand)."""
        if self.schedule is not None:
            return self.schedule
        if self.program is None:
            raise CompileError(
                "cache-hydrated artifact has no program attached; "
                "re-compile through the driver to replay its schedule")
        from .driver import recompile_schedule
        recompile_schedule(self)
        return self.schedule

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        d = {"schema": ARTIFACT_SCHEMA, "key": self.key,
             "program_name": self.program_name, "program_fp": self.program_fp,
             "graph_name": self.graph_name, "graph_fp": self.graph_fp,
             "approach_fp": self.approach_fp, "backend": self.backend,
             "cost": self.cost,
             "instrs": [p.to_dict() for p in self.instrs],
             "counts": dict(self.counts), "bytes_moved": self.bytes_moved,
             "lowering": dict(self.lowering), "meta": dict(self.meta)}
        if self.fabric is not None:
            d["fabric"] = self.fabric
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CompiledKernel":
        return cls(key=d["key"], program_name=d.get("program_name", ""),
                   program_fp=d.get("program_fp", ""),
                   graph_name=d.get("graph_name", ""),
                   graph_fp=d.get("graph_fp", ""),
                   approach_fp=d.get("approach_fp", ""),
                   backend=d.get("backend", "cost"),
                   cost=float(d.get("cost", 0.0)),
                   instrs=tuple(InstrPlan.from_dict(p)
                                for p in d.get("instrs", [])),
                   counts=dict(d.get("counts", {})),
                   bytes_moved=int(d.get("bytes_moved", 0)),
                   lowering=dict(d.get("lowering", {})),
                   fabric=d.get("fabric"),
                   meta=dict(d.get("meta", {})),
                   from_cache=True)

    def summary(self) -> str:
        tile = ""
        try:
            tile = f" tile={self.gemm_tile()}"
        except CompileError:
            pass
        src = "cache" if self.from_cache else "fresh"
        fab = (f" fabric(axis={self.fabric.get('axis')},"
               f"alg={self.fabric.get('algorithm')},"
               f"chips={self.fabric.get('chips')})" if self.fabric else "")
        return (f"{self.program_name} on {self.graph_name}: "
                f"cost={self.cost:.3e}s{tile}"
                f" lowering={self.lowering.get('kind', '-')}{fab} [{src}]")
