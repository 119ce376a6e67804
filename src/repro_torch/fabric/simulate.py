"""Event-driven distributed schedule simulator.

    PYTHONPATH=src python -m repro_torch.fabric.simulate \\
        --shape 5124x700x2048 --chips 4 --topology ring

Takes a partition choice (``partition.py``), runs the *existing* static
scheduler on every per-chip subprogram, lowers the implied collectives to
COPY streams (``collectives.py``), and replays everything on one global
event timeline: each chip's compute/DMA resources plus every fabric link
get their own FIFO timeline, and tasks carry explicit dependencies —

  * per-chip ops depend on region availability exactly as
    ``scheduler.cost_model`` models it (the per-chip replay with no fabric
    reproduces ``cost_model`` makespans op for op);
  * a gathered operand's region at its home HBM becomes available only
    when the covering collective chunks *arrive*, so compute overlaps the
    tail of an operand all-gather;
  * a reduce/gather send becomes ready only when the sending chip's local
    partial for that chunk is complete (tracked per output chunk from the
    schedule's writebacks), so output collectives overlap the compute
    front.

The reported makespan is directly comparable to the single-chip
``scheduler.cost_model()`` number — same compute/DMA durations, same
semantics, one extra resource class (fabric links).

``FabricEvaluator`` scores a joint (partition axis, collective algorithm,
per-chip tiles) config for ``repro_torch.search``.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass

from ..compile import CompileError, compile_selection
from ..core.scheduler import Region, Schedule, ScheduleError, compute_time
from ..core.sysgraph import SystemGraph
from ..search.space import Config, ParamApproach
from .collectives import (ALGORITHMS, CollectiveStep, lower_all_gather,
                          lower_all_reduce, lower_reduce_scatter)
from .partition import (CollectiveSpec, PartitionedProgram, partition,
                        partition_axes, replay_bitexact, split_extent)
from .topology import Topology, make_topology

#: Oracle-validation proxies cap each axis (full DeepBench shapes would
#: materialize intractable NumPy temporaries — same policy as repro_torch.search).
VALIDATE_DIM_CAP = 192


# --------------------------------------------------------------------------- #
# The event timeline
# --------------------------------------------------------------------------- #


@dataclass
class _Task:
    tid: str
    resource: str | None
    duration: float
    deps: tuple[str, ...]
    ready: float


class EventSim:
    """Deterministic discrete-event timeline: tasks on FIFO resources.

    Tasks are added in a valid topological order (asserted) and each
    resource executes its tasks in insertion order — exactly the
    in-stream-order semantics of ``scheduler.cost_model``, extended with
    explicit cross-chip dependencies.  ``run`` is then a single relaxation
    pass: ``start = max(ready, deps' ends, resource free)``.
    """

    def __init__(self):
        self._tasks: list[_Task] = []
        self._known: set[str] = set()

    @property
    def tasks(self) -> list[tuple[str, tuple[str, ...]]]:
        """(tid, deps) pairs in insertion order — the auditable dependency
        graph ``repro_torch.verify.fabric.verify_task_graph`` checks."""
        return [(t.tid, t.deps) for t in self._tasks]

    def add(self, tid: str, resource: str | None = None,
            duration: float = 0.0, deps=(), ready: float = 0.0) -> str:
        if tid in self._known:
            raise ValueError(f"duplicate task id {tid}")
        for d in deps:
            if d not in self._known:
                raise ValueError(f"task {tid} depends on unknown {d}")
        self._known.add(tid)
        self._tasks.append(_Task(tid, resource, duration, tuple(deps), ready))
        return tid

    def run(self) -> dict[str, tuple[float, float]]:
        free: dict[str, float] = {}
        times: dict[str, tuple[float, float]] = {}
        for t in self._tasks:
            start = t.ready
            for d in t.deps:
                start = max(start, times[d][1])
            if t.resource is not None:
                start = max(start, free.get(t.resource, 0.0))
            end = start + t.duration
            times[t.tid] = (start, end)
            if t.resource is not None:
                free[t.resource] = end
        return times


# --------------------------------------------------------------------------- #
# Per-chip schedule replay
# --------------------------------------------------------------------------- #


def _bounds_rows_overlap(bounds: tuple, axis: int, off: int, ln: int) -> bool:
    if axis >= len(bounds):
        return True
    s, n = bounds[axis]
    return s < off + ln and off < s + n


def _add_chip_schedule(sim: EventSim, chip: int, sched: Schedule,
                       initial_dep=None,
                       out_chunks: list[tuple[int, int, int]] | None = None,
                       out_buffer: str = "", out_axis: int = 0,
                       ) -> dict[int, str]:
    """Feed one chip's scheduled op stream into the timeline.

    ``initial_dep(region, node) -> [tids]`` supplies arrival dependencies
    for data that is *not* resident at t=0 (gathered operands).
    ``out_chunks`` = [(chunk_id, off, len)] along ``out_axis`` of
    ``out_buffer``; returns a zero-duration *done marker* per chunk whose
    end time is when the chunk is complete in the chip's home memory.
    """
    g = sched.graph
    pre = f"c{chip}:"
    avail: dict[tuple, str] = {}     # ((buffer, bounds), node) -> producer tid

    def _initial(region: Region, node: str) -> list[str]:
        return initial_dep(region, node) if initial_dep else []

    for op in sched.ops:
        tid = f"{pre}op{op.uid}"
        if op.kind in ("copy", "writeback"):
            k = (op.region.buffer, op.region.bounds)
            deps = ([avail[(k, op.src)]] if (k, op.src) in avail
                    else _initial(op.region, op.src))
            e = g.edge(op.src, op.dst)
            dur = e.latency + sched.region_nbytes(op.region) / e.bandwidth
            sim.add(tid, resource=f"{pre}dma:{op.src}->{op.dst}",
                    duration=dur, deps=deps)
            avail[(k, op.dst)] = tid
        else:
            dev = g.computes[op.device]
            mem = dev.memory
            deps = []
            for _, region, r, _ in op.tile.operands:
                if not r:
                    continue
                key = ((region.buffer, region.bounds), mem)
                if key in avail:
                    deps.append(avail[key])
                else:
                    deps.extend(_initial(region, mem))
            sim.add(tid, resource=f"{pre}{op.device}",
                    duration=compute_time(dev, op.tile), deps=deps)
            for _, region, _, w in op.tile.operands:
                if w:
                    avail[((region.buffer, region.bounds), mem)] = tid

    done: dict[int, str] = {}
    if out_chunks:
        home = sched.homes.get(out_buffer, "")
        for chunk_id, off, ln in out_chunks:
            deps = [tid for (k, node), tid in avail.items()
                    if k[0] == out_buffer and node == home
                    and _bounds_rows_overlap(k[1], out_axis, off, ln)]
            done[chunk_id] = sim.add(f"{pre}done:{out_buffer}:{chunk_id}",
                                     deps=sorted(set(deps)))
    return done


class _StaggeredUnroll:
    """Per-chip unroll rotation for compute/communication overlap.

    With every chip walking its output rows in the same ascending order,
    the ring chain for the *last* chunk cannot start before compute ends —
    zero overlap.  Chip *i* instead computes its own chunk first, then
    alternates outward (i, i-1, i+1, i-2, ...), so the clockwise and
    counter-clockwise chains both find their early hops ready while later
    chunks are still computing.  This is a pure reordering across output
    regions — reduction offsets stay ascending within each region, so the
    bit-exactness contract is untouched.  Everything except
    ``unroll_order`` delegates to the wrapped Approach.
    """

    def __init__(self, inner, chip: int, n_chips: int,
                 chunks: tuple[tuple[int, int], ...], axis: int):
        self._inner = inner
        self._chip = chip
        self._p = n_chips
        self._chunks = chunks
        self._axis = axis

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _rank(self, tile) -> int:
        region = tile.output_region()
        if region is None or self._axis >= len(region.bounds):
            return 0
        start = region.bounds[self._axis][0]
        c = 0
        for j, (off, ln) in enumerate(self._chunks):
            if off <= start < off + ln:
                c = j
                break
        if c == self._chip:
            return 0
        back = (self._chip - c) % self._p
        fwd = (c - self._chip) % self._p
        return 2 * back - 1 if back <= fwd else 2 * fwd

    def unroll_order(self, tiles):
        ordered = self._inner.unroll_order(tiles)
        return sorted(ordered, key=self._rank)      # stable: inner order kept


# --------------------------------------------------------------------------- #
# Collective phases on link timelines
# --------------------------------------------------------------------------- #


def _add_collective(sim: EventSim, topo: Topology, steps: list[CollectiveStep],
                    prefix: str,
                    done: dict[tuple[int, int], str] | None = None,
                    ) -> dict[tuple[int, int], str]:
    """Replay lowered collective steps over the fabric's link resources.

    Step chips/chunks are *positions in topo.ring_order*; this resolves
    them to chip ids and routes each logical hop over ``topo.path`` (one
    task per physical link — a host-tree hop is two PCIe tasks).  Returns
    ``(chip, chunk) -> tid`` arrival markers.
    """
    order = topo.ring_order
    last: dict[tuple[int, int], str] = {}        # (dir, chunk pos) -> tid
    arrivals: dict[tuple[int, int], str] = {}
    for st in steps:
        src, dst = order[st.src], order[st.dst]
        chunk = order[st.chunk]
        deps = []
        chain = (st.direction, st.chunk)
        if chain in last:
            deps.append(last[chain])
        if done:
            mark = done.get((src, chunk))
            if mark:
                deps.append(mark)
        tid = ""
        for hop, link in enumerate(topo.path(src, dst)):
            tid = sim.add(
                f"{prefix}:d{st.direction}:s{st.step}:c{chunk}"
                f":{src}->{dst}:h{hop}",
                resource=f"link:{link.src}->{link.dst}",
                duration=link.latency + st.nbytes / link.bandwidth,
                deps=deps)
            deps = [tid]
        last[chain] = tid
        arrivals[(dst, chunk)] = tid
    return arrivals


def _lower(spec: CollectiveSpec, pp: PartitionedProgram, topo: Topology,
           algorithm: str) -> list[CollectiveStep]:
    nbytes = spec.chunk_nbytes(pp.base)
    # lowering speaks ring positions: re-index chunk bytes by position
    by_pos = [nbytes[topo.ring_order[q]] for q in range(topo.n_chips)]
    lowerer = {"all_gather": lower_all_gather,
               "reduce_scatter": lower_reduce_scatter,
               "all_reduce": lower_all_reduce}[spec.kind]
    return lowerer(topo.n_chips, by_pos, algorithm,
                   phase=f"{spec.kind}:{spec.buffer}")


# --------------------------------------------------------------------------- #
# The simulator proper
# --------------------------------------------------------------------------- #


@dataclass
class FabricResult:
    axis: str
    algorithm: str
    makespan: float
    chip_spans: list[float]             # per-chip last local-op end
    comm_end: float                     # last collective task end (0 if none)
    n_tasks: int
    n_collective_steps: int

    @property
    def comm_bound(self) -> bool:
        return self.comm_end >= self.makespan * (1 - 1e-9) and self.comm_end > 0


def simulate_partition(pp: PartitionedProgram, topo: Topology,
                       approach=None, algorithm: str = "ring",
                       chip_graph: SystemGraph | None = None,
                       sim_out: list | None = None) -> FabricResult:
    """Distributed makespan of one partition choice on one fabric.

    ``sim_out``, when given, receives the assembled ``EventSim`` so callers
    (``repro_torch.verify``) can audit the task graph without re-building it."""
    if topo.n_chips != len(pp.shards):
        raise ValueError(
            f"partition has {len(pp.shards)} shards but the topology has "
            f"{topo.n_chips} chips — repartition for this fabric")
    chip_graph = chip_graph or Topology.chip_graph()
    pre = [c for c in pp.collectives if c.when == "pre"]
    post = [c for c in pp.collectives if c.when == "post"]

    # With a collective in play, each chip gets its own staggered unroll
    # (own chunk first) so ring chains overlap the compute front; without
    # one, chips are symmetric and a single schedule is shared.
    stagger = (post or pre) and topo.n_chips > 1
    stagger_spec = (post or pre)[0] if stagger else None
    scheds: dict[tuple, Schedule] = {}
    for shard in pp.shards:
        key = (shard.program.signature(), shard.chip if stagger else -1)
        if key not in scheds:
            app = approach
            if stagger:
                from ..core.approach import GreedyApproach
                app = _StaggeredUnroll(approach or GreedyApproach(),
                                       shard.chip, topo.n_chips,
                                       stagger_spec.chunks, stagger_spec.axis)
            # per-chip compile through the repro_torch.compile driver
            scheds[key] = compile_selection(pp.shard_selection(shard),
                                            chip_graph, app).schedule

    sim = EventSim()

    # 1. operand collectives (data is shard-resident at t=0)
    arrivals: dict[str, dict[tuple[int, int], str]] = {}
    steps_total = 0
    for spec in pre:
        steps = _lower(spec, pp, topo, algorithm)
        steps_total += len(steps)
        arrivals[spec.buffer] = _add_collective(
            sim, topo, steps, prefix=f"pre:{spec.kind}:{spec.buffer}")

    # 2. per-chip schedules, gated on operand arrivals
    out_buffer = pp.output
    done_all: dict[tuple[int, int], str] = {}
    chip_tids: dict[int, list[str]] = {}
    for shard in pp.shards:
        sched = scheds[(shard.program.signature(),
                        shard.chip if stagger else -1)]
        chip = shard.chip

        def initial_dep(region: Region, node: str, _chip=chip,
                        _sched=sched) -> list[str]:
            deps = []
            for spec in pre:
                if region.buffer != spec.buffer:
                    continue
                if node != _sched.homes.get(spec.buffer):
                    continue
                arr = arrivals[spec.buffer]
                for j, (off, ln) in enumerate(spec.chunks):
                    if j == _chip:
                        continue         # own shard: resident at t=0
                    if not _bounds_rows_overlap(region.bounds, spec.axis,
                                                off, ln):
                        continue
                    tid = arr.get((_chip, j))
                    if tid:
                        deps.append(tid)
            return deps

        # Done markers for the output collective.  In chain_sum mode (k)
        # every chip holds a full-size partial, so local coordinates equal
        # the global chunk bounds; in concat mode the subprogram is the
        # shard itself, so the chip's own chunk spans its whole local dim.
        chunks = None
        out_axis = 0
        for spec in post:
            if spec.buffer != out_buffer:
                continue
            out_axis = spec.axis
            if pp.out_mode == "chain_sum":
                chunks = [(j, off, ln)
                          for j, (off, ln) in enumerate(spec.chunks)]
            else:
                local = shard.program.buffer(out_buffer).shape[spec.axis]
                chunks = [(chip, 0, local)]
        before = len(sim._tasks)
        done = _add_chip_schedule(sim, chip, sched,
                                  initial_dep=initial_dep if pre else None,
                                  out_chunks=chunks, out_buffer=out_buffer,
                                  out_axis=out_axis)
        chip_tids[chip] = [t.tid for t in sim._tasks[before:]]
        for j, tid in done.items():
            done_all[(chip, j)] = tid

    # 3. output collectives, gated on per-chunk completion
    comm_tids: list[str] = []
    for spec in post:
        steps = _lower(spec, pp, topo, algorithm)
        steps_total += len(steps)
        before = len(sim._tasks)
        _add_collective(sim, topo, steps,
                        prefix=f"post:{spec.kind}:{spec.buffer}",
                        done=done_all)
        comm_tids.extend(t.tid for t in sim._tasks[before:])
    for arr in arrivals.values():
        comm_tids.extend(arr.values())

    if sim_out is not None:
        sim_out.append(sim)
    times = sim.run()
    makespan = max((end for _, end in times.values()), default=0.0)
    chip_spans = [max((times[t][1] for t in chip_tids.get(c, [])), default=0.0)
                  for c in range(len(pp.shards))]
    comm_end = max((times[t][1] for t in comm_tids), default=0.0)
    return FabricResult(pp.axis, algorithm, makespan, chip_spans, comm_end,
                        len(sim._tasks), steps_total)


def single_chip_makespan(pp: PartitionedProgram,
                         chip_graph: SystemGraph | None = None,
                         approach=None) -> float:
    """The 1-chip reference: the full program compiled through the driver on
    one chip — the exact ``scheduler.cost_model()`` number."""
    chip_graph = chip_graph or Topology.chip_graph()
    one = partition(pp.kernel, _shape_of(pp), partition_axes(pp.kernel)[0], 1)
    sel = one.shard_selection(one.shards[0])
    return compile_selection(sel, chip_graph, approach).cost


def _shape_of(pp: PartitionedProgram) -> tuple[int, ...]:
    base = pp.base
    if pp.kernel == "gemm":
        return (base.buffer("A").shape[0], base.buffer("B").shape[1],
                base.buffer("A").shape[1])
    return (base.buffer("X").shape[0], base.buffer("H").shape[1])


def replicate_output(pp: PartitionedProgram) -> PartitionedProgram:
    """Upgrade the output contract from *sharded* to *replicated*: the k
    reduce-scatter becomes a full all-reduce and concat axes gain a post
    all-gather of the output."""
    out = pp.output
    dim = pp.base.buffer(out).shape[pp.out_axis]
    chunks = tuple(split_extent(dim, pp.n_chips))
    collectives = []
    has_post = False
    for c in pp.collectives:
        if c.when == "post" and c.kind == "reduce_scatter":
            c = CollectiveSpec("all_reduce", c.buffer, "post", c.axis,
                               c.chunks)
        if c.when == "post":
            has_post = True
        collectives.append(c)
    if not has_post and pp.n_chips > 1:
        collectives.append(CollectiveSpec("all_gather", out, "post",
                                          pp.out_axis, chunks))
    return PartitionedProgram(pp.base, pp.kernel, pp.axis, pp.n_chips,
                              pp.shards, collectives, pp.out_mode,
                              pp.out_axis)


# --------------------------------------------------------------------------- #
# Graph-level replay (repro_torch.graph)
# --------------------------------------------------------------------------- #


def simulate_kernel_graph(kgraph, node_costs: dict, residency: dict,
                          graph: SystemGraph | None = None, *,
                          double_buffer: bool = True) -> dict:
    """Replay a compiled ``repro_torch.graph.KernelGraph`` on one chip's event
    timeline: every node is a compute task (duration = its kernel's modeled
    makespan), and inter-kernel tensors turn into DMA tasks on the HBM→VMEM
    edge according to ``residency``:

      * graph inputs stream in once over the DMA edge (weight-stationary:
        they stay resident for every consumer);
      * an intermediate placed ``"vmem"`` is handed to consumers directly —
        the compute task dependency alone, no traffic;
      * an intermediate placed ``"hbm"`` (spilled by ``plan_placement``) is
        stored once after its producer and re-loaded per consumer;
      * graph outputs are written back to HBM.

    With ``double_buffer`` (the default) a node's loads overlap its compute
    instead of fully serializing before it: every HBM→VMEM transfer feeding
    a node is two half-size chunk tasks (total DMA occupancy unchanged —
    the edge latency rides on the first chunk) and every node is two
    half-cost phases on the core; phase 1 may start once each streamed
    operand's *first* chunk has landed, phase 2 needs the full operands.
    Dependencies only weaken, so no task finishes later than in the
    serialized schedule — and whenever a load gates a compute the critical
    path strictly shortens.  Stores stay whole: a writeback cannot start
    before its producer finishes.

    ``node_costs`` maps node name → seconds.  Returns the makespan, the
    modeled HBM traffic in bytes, and the auditable ``(tid, deps)`` task
    pairs (``repro_torch.verify.fabric.verify_task_graph`` checks them — the
    same acyclicity/unknown-dep rules the collective timelines obey).
    """
    from ..core.sysgraph import tpu_v5e
    g = graph if graph is not None else tpu_v5e(1)
    vmem = max(g.memories.values(), key=lambda m: m.level)
    feed = next(e for e in g.edges
                if e.dst == vmem.name
                and g.memories[e.src].level == vmem.level - 1)
    core = next(c for c in g.computes.values() if c.memory == vmem.name)
    dma = f"{feed.src}->{feed.dst}"

    def xfer(nbytes: int) -> float:
        return feed.latency + nbytes / feed.bandwidth

    sim = EventSim()
    produced_by: dict[str, str] = {}          # tensor -> producing task id
    first_chunk: dict[str, str] = {}          # transfer tid -> chunk-1 tid
    hbm_bytes = 0
    spilled = {t for t, loc in residency.items() if loc == "hbm"}

    def add_load(tid: str, nbytes: int, deps=()) -> None:
        nonlocal hbm_bytes
        hbm_bytes += nbytes
        if double_buffer:
            half = nbytes / (2 * feed.bandwidth)
            a = sim.add(f"{tid}:a", resource=dma,
                        duration=feed.latency + half, deps=deps)
            sim.add(tid, resource=dma, duration=half, deps=(a,))
            first_chunk[tid] = a
        else:
            sim.add(tid, resource=dma, duration=xfer(nbytes), deps=deps)

    for t in kgraph.inputs:
        add_load(f"load:{t}", kgraph.tensors[t].nbytes)
        produced_by[t] = f"load:{t}"
    for node in kgraph.nodes:
        deps = []
        for t in node.consumed():
            if t in spilled:
                tid = f"load:{t}:{node.name}"
                add_load(tid, kgraph.tensors[t].nbytes,
                         deps=(f"store:{t}",))
                deps.append(tid)
            else:
                deps.append(produced_by[t])
        cost = float(node_costs[node.name])
        if double_buffer:
            early = tuple(first_chunk.get(d, d) for d in deps)
            p1 = sim.add(f"{node.name}:p1", resource=core.name,
                         duration=cost / 2, deps=early)
            sim.add(node.name, resource=core.name, duration=cost / 2,
                    deps=(p1, *deps))
        else:
            sim.add(node.name, resource=core.name,
                    duration=cost, deps=tuple(deps))
        for t in node.produced():
            produced_by[t] = node.name
            if t in spilled:
                sim.add(f"store:{t}", resource=dma,
                        duration=xfer(kgraph.tensors[t].nbytes),
                        deps=(node.name,))
                hbm_bytes += kgraph.tensors[t].nbytes
    for t in kgraph.outputs:
        sim.add(f"store:out:{t}", resource=dma,
                duration=xfer(kgraph.tensors[t].nbytes),
                deps=(produced_by[t],))
        hbm_bytes += kgraph.tensors[t].nbytes
    times = sim.run()
    makespan = max((end for _, end in times.values()), default=0.0)
    return {"makespan": makespan, "hbm_bytes": hbm_bytes,
            "n_tasks": len(sim._tasks), "tasks": sim.tasks, "times": times}


# --------------------------------------------------------------------------- #
# Search integration
# --------------------------------------------------------------------------- #


class FabricEvaluator:
    """Score a joint (partition axis, collective algorithm, per-chip tile)
    config by the simulated distributed makespan.  Plugs straight into the
    ``repro_torch.search`` strategies; use with ``SearchSpace.for_fabric`` so the
    baseline point (axis=m, ring, greedy tiles) anchors the search."""

    def __init__(self, kernel: str, shape: tuple[int, ...], topo: Topology,
                 max_tiles: int = 4096, replicate_out: bool = False):
        self.kernel = kernel
        self.shape = shape
        self.topo = topo
        self.max_tiles = max_tiles
        self.replicate_out = replicate_out
        self.chip_graph = Topology.chip_graph()
        self._pps: dict[str, PartitionedProgram] = {}

    def pp(self, axis: str) -> PartitionedProgram:
        if axis not in self._pps:
            p = partition(self.kernel, self.shape, axis, self.topo.n_chips)
            if self.replicate_out:
                p = replicate_output(p)
            self._pps[axis] = p
        return self._pps[axis]

    def __call__(self, config: Config) -> float:
        from ..search.evaluate import CostModelEvaluator
        axis = config.get("part_axis", partition_axes(self.kernel)[0])
        algorithm = config.get("collective", "ring")
        if axis not in partition_axes(self.kernel) \
                or algorithm not in ALGORITHMS:
            return float("inf")
        approach = ParamApproach(config)
        pp = self.pp(axis)
        try:
            seen = set()
            for shard in pp.shards:
                sig = shard.program.signature()
                if sig in seen:
                    continue
                seen.add(sig)
                guard = CostModelEvaluator(pp.shard_selection(shard),
                                           self.chip_graph,
                                           max_tiles=self.max_tiles)
                if guard.estimated_tiles(approach) > self.max_tiles:
                    return float("inf")
            return simulate_partition(pp, self.topo, approach, algorithm,
                                      self.chip_graph).makespan
        except (CompileError, ScheduleError, ValueError):
            return float("inf")


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #


def _parse_shape(text: str, kernel: str) -> tuple[int, ...]:
    dims = tuple(int(x) for x in text.lower().split("x"))
    want = 3 if kernel == "gemm" else 2
    if len(dims) != want:
        raise argparse.ArgumentTypeError(
            f"{kernel} shape needs {want} dims (got {text!r})")
    return dims


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fabric.simulate",
        description="Event-driven multi-chip schedule simulator: partition "
                    "a GEMM/GRU, lower the implied collectives, replay "
                    "per-chip schedules + fabric phases, report makespans "
                    "vs the 1-chip schedule.")
    ap.add_argument("--shape", default="5124x700x2048",
                    help="MxNxK for gemm, BATCHxHIDDEN for gru")
    ap.add_argument("--kernel", choices=["gemm", "gru"], default="gemm")
    ap.add_argument("--chips", type=int, default=4)
    ap.add_argument("--topology", choices=["ring", "torus", "host"],
                    default="ring")
    ap.add_argument("--axis", default="all",
                    help="partition axis (m|n|k|batch) or 'all'")
    ap.add_argument("--algorithm", choices=("best",) + ALGORITHMS,
                    default="best",
                    help="collective algorithm ('best' tries all and "
                         "reports the winner per axis)")
    ap.add_argument("--replicate-out", action="store_true",
                    help="require the output replicated on every chip "
                         "(k: all-reduce; m/n/batch: output all-gather) "
                         "instead of the default sharded-output contract")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip the proxy-sized bit-exact oracle replay")
    ap.add_argument("--proxy-cap", type=int, default=VALIDATE_DIM_CAP,
                    help="per-axis size cap for the oracle proxy")
    ap.add_argument("--json", default=None, help="write the report here")
    args = ap.parse_args(argv)

    shape = _parse_shape(args.shape, args.kernel)
    topo = make_topology(args.topology, args.chips)
    axes = partition_axes(args.kernel) if args.axis == "all" else (args.axis,)
    algorithms = ALGORITHMS if args.algorithm == "best" else (args.algorithm,)
    chip_graph = Topology.chip_graph()

    base_pp = partition(args.kernel, shape, axes[0], 1)
    one_chip = single_chip_makespan(base_pp, chip_graph)
    print(f"# fabric simulate: kernel={args.kernel} shape={args.shape} "
          f"chips={args.chips} topology={topo.name} "
          f"contract={'replicated' if args.replicate_out else 'sharded'}-out")
    print(f"# 1-chip modeled makespan: {one_chip:.3e} s")

    rows = []
    failures = 0
    best_row = None
    for axis in axes:
        pp = partition(args.kernel, shape, axis, args.chips)
        if args.replicate_out:
            pp = replicate_output(pp)
        results = [simulate_partition(pp, topo, None, alg, chip_graph)
                   for alg in algorithms]
        res = min(results, key=lambda r: r.makespan)
        exact = None
        if not args.no_validate:
            proxy_shape = tuple(max(args.chips, min(d, args.proxy_cap))
                                for d in shape)
            proxy = partition(args.kernel, proxy_shape, axis, args.chips)
            if args.replicate_out:
                proxy = replicate_output(proxy)
            report = replay_bitexact(proxy, chip_graph)
            exact = report.exact
            if not exact:
                failures += 1
        speedup = one_chip / res.makespan if res.makespan else float("inf")
        row = {"axis": axis, "algorithm": res.algorithm,
               "makespan_s": res.makespan, "one_chip_s": one_chip,
               "speedup": speedup, "comm_end_s": res.comm_end,
               "comm_bound": res.comm_bound,
               "collective_steps": res.n_collective_steps,
               "tasks": res.n_tasks, "oracle_exact": exact}
        rows.append(row)
        if best_row is None or row["makespan_s"] < best_row["makespan_s"]:
            best_row = row
        vtxt = "-" if exact is None else ("exact" if exact else "MISMATCH")
        mark = "<" if speedup > 1.0 else ">="
        print(f"axis={axis:<5} alg={res.algorithm:<5} "
              f"makespan={res.makespan:.3e}s ({mark} 1-chip, "
              f"speedup={speedup:.2f}x) comm_end={res.comm_end:.3e}s "
              f"oracle={vtxt}")
    if best_row:
        print(f"# best: axis={best_row['axis']} alg={best_row['algorithm']} "
              f"speedup={best_row['speedup']:.2f}x")

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"schema": 1, "kernel": args.kernel,
                       "shape": list(shape), "chips": args.chips,
                       "topology": topo.name,
                       "replicate_out": bool(args.replicate_out),
                       "one_chip_s": one_chip, "failures": failures,
                       "rows": rows}, f, indent=2)
        print(f"# report: {args.json}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
