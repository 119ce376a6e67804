"""Mutation harness — proof that the static analyzer has teeth.

Each registered mutation takes a *known-good* compile bundle (program +
selection + schedule off a real ``compile_*`` run, or a real fabric
partition/collective plan), corrupts it in one specific way, re-runs the
verifier stack and reports which rules fired.  ``run_all`` asserts two
properties the test-suite pins down:

  * every corruption class is **caught**, with the expected rule id among
    the findings (one mutation ~ one primary diagnostic), and
  * the **unmutated** bundles verify clean (zero false positives).

Mutations bypass the IR constructors on purpose (``object.__setattr__`` on
frozen dataclasses): real corruption — bad serialization, a buggy pass, a
hand-edited cache — does not politely call ``__post_init__``.

The bundles compile on the port's default target (``gpu_sm(8)``) wherever
the JAX package's compile on its own default (``tpu_v5e(1)``); the ``gpu``
and ``incremental`` bundles name their targets, as the JAX package's do.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field, replace

from ..core.scheduler import Region
from .diagnostics import RULES, Diagnostic, DiagnosticReport
from .program import verify_program
from .schedule import verify_reschedule, verify_schedule
from .selection import verify_selection

# --------------------------------------------------------------------------- #
# Bundles: one real compile / partition per workload, deep-copied per mutation
# --------------------------------------------------------------------------- #


@dataclass
class Bundle:
    """Everything one mutation may corrupt (a deep copy per run)."""

    program: object = None
    selection: object = None
    schedule: object = None
    approach: object = None
    artifact: dict | None = None          # serialized CompiledKernel payload
    partition: object = None              # fabric PartitionedProgram
    topo: object = None
    steps: dict = field(default_factory=dict)   # collective kind -> steps
    tasks: list = field(default_factory=list)   # EventSim (tid, deps) pairs
    kgraph: object = None                 # repro_torch.graph KernelGraph
    locations: dict = field(default_factory=dict)  # tensor -> vmem|hbm
    budget: int = 0
    trace: dict = field(default_factory=dict)   # repro_torch.serve run trace
    trace2: dict = field(default_factory=dict)  # its bit-identical twin
    sysgraph: object = None               # SystemGraph (incremental kind)
    parent_schedule: object = None        # anchor schedule to resume from
    segments: dict = field(default_factory=dict)  # idx -> (op count, state)
    first_changed: int = 0                # first instr whose tile differs


_BASE: dict[str, Bundle] = {}


def _gemm_bundle() -> Bundle:
    if "gemm" not in _BASE:
        from ..compile.driver import compile_gemm
        art = compile_gemm(64, 32, 48, use_cache=False)
        _BASE["gemm"] = Bundle(program=art.selection.program,
                               selection=art.selection,
                               schedule=art.ensure_schedule(),
                               approach=art.approach,
                               artifact=art.to_dict())
    return copy.deepcopy(_BASE["gemm"])


def _gpu_bundle() -> Bundle:
    """A known-good compile on the GPU target: same program family as the
    gemm bundle, but scheduled against ``gpu_sm`` shared memory and lowered
    to the ``pallas_gpu_gemm`` config — the surface the two GPU corruption
    classes attack."""
    if "gpu" not in _BASE:
        from ..compile.driver import compile_gemm
        from ..core.sysgraph import gpu_sm
        art = compile_gemm(64, 32, 48, graph=gpu_sm(2), use_cache=False)
        _BASE["gpu"] = Bundle(program=art.selection.program,
                              selection=art.selection,
                              schedule=art.ensure_schedule(),
                              approach=art.approach,
                              artifact=art.to_dict())
    return copy.deepcopy(_BASE["gpu"])


def _fabric_bundle() -> Bundle:
    if "fabric" not in _BASE:
        from ..fabric.partition import partition
        from ..fabric.simulate import _lower, simulate_partition
        from ..fabric.topology import make_topology
        topo = make_topology("ring", 4)
        # n-partition lowers an all_gather, k-partition a reduce chain.
        pp = partition("gemm", (256, 128, 64), "n", topo.n_chips)
        ppk = partition("gemm", (256, 128, 64), "k", topo.n_chips)
        steps = {spec.kind: _lower(spec, pp, topo, "ring")
                 for spec in pp.collectives}
        steps.update({spec.kind: _lower(spec, ppk, topo, "ring")
                      for spec in ppk.collectives})
        sim_out: list = []
        simulate_partition(pp, topo, None, "ring", None, sim_out=sim_out)
        tasks = [(t.tid, tuple(t.deps)) for t in sim_out[0]._tasks]
        _BASE["fabric"] = Bundle(partition=pp, topo=topo, steps=steps,
                                 tasks=tasks)
    return copy.deepcopy(_BASE["fabric"])


def _graph_bundle() -> Bundle:
    if "graph" not in _BASE:
        from ..configs.registry import get_trace_config
        from ..graph.compile import plan_placement
        from ..graph.fuse import fuse_epilogues
        from ..graph.trace import trace_block
        g, _ = fuse_epilogues(
            trace_block(get_trace_config("olmo-1b"), seq_len=4))
        budget = 4096    # small enough that the plan mixes vmem and hbm
        pl = plan_placement(g, budget)
        _BASE["graph"] = Bundle(kgraph=g, locations=dict(pl.locations),
                                budget=budget)
    return copy.deepcopy(_BASE["graph"])


def _serve_bundle() -> Bundle:
    if "serve" not in _BASE:
        import copy as _copy
        from ..serve.bucket import ServingPool
        from ..serve.scheduler import FifoOnlineScheduler
        from ..serve.simulate import ServeParams, simulate_serving
        from ..serve.workload import generate_requests
        pool = ServingPool(archs=("olmo-1b",), buckets=(4, 8),
                           use_cache=False)
        pool.warmup()
        reqs = generate_requests(8, seed=3, rate=400.0,
                                 prompt_lens=(2, 4, 6, 8),
                                 decode_lens=(1, 2, 3))
        res = simulate_serving(reqs, pool, FifoOnlineScheduler(),
                               ServeParams(max_batch=4, kv_budget=1 << 15))
        trace = res.trace()
        _BASE["serve"] = Bundle(trace=trace, trace2=_copy.deepcopy(trace))
    return copy.deepcopy(_BASE["serve"])


def _incremental_bundle() -> Bundle:
    """A real incremental re-schedule: a heterogeneous GRU (input dim !=
    hidden dim) whose first matmul's reduction (k=64, below the hardware
    tile) is cap-invariant, so a ``tile_k`` change shares an unchanged
    instruction-0 prefix with the baseline anchor — ``first_changed`` is 1
    and the child schedule genuinely resumes mid-stream."""
    if "incremental" not in _BASE:
        from ..compile.driver import gru_selection
        from ..core.scheduler import (schedule_incremental,
                                      schedule_with_segments)
        from ..core.sysgraph import tpu_v5e
        from ..search.space import ParamApproach, SearchSpace
        graph = tpu_v5e(1)
        _, sel = gru_selection(4, 256, 64)
        base = SearchSpace.for_graph(graph).baseline()
        parent, segments = schedule_with_segments(sel, graph,
                                                  ParamApproach(base))
        child_ap = ParamApproach(dict(base, tile_k=128))
        child, _ = schedule_incremental(sel, graph, child_ap, parent,
                                        segments, 1)
        _BASE["incremental"] = Bundle(
            program=sel.program, selection=sel, schedule=child,
            approach=child_ap, sysgraph=graph, parent_schedule=parent,
            segments=segments, first_changed=1)
    return copy.deepcopy(_BASE["incremental"])


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #

#: name -> (expected rule, bundle kind, mutator).  The mutator corrupts the
#: bundle in place and may return a Diagnostic list of its own (fabric/art
#: classes verify sub-objects directly).
MUTATIONS: dict[str, tuple[str, str, object]] = {}


def mutation(name: str, rule: str, kind: str = "gemm"):
    if rule not in RULES:
        raise KeyError(f"unregistered verify rule {rule!r}")

    def register(fn):
        MUTATIONS[name] = (rule, kind, fn)
        return fn
    return register


def _verify_bundle(b: Bundle) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    if b.program is not None:
        diags.extend(verify_program(b.program))
    if b.selection is not None:
        diags.extend(verify_selection(b.selection, b.approach))
    if b.schedule is not None:
        diags.extend(verify_schedule(b.schedule, b.approach))
        if b.selection is not None and b.approach is not None:
            diags.extend(verify_reschedule(b.schedule, b.selection,
                                           b.approach))
    if b.kgraph is not None:
        from .graph import verify_graph, verify_placement
        diags.extend(verify_graph(b.kgraph))
        diags.extend(verify_placement(b.kgraph, b.locations, b.budget))
    if b.trace:
        from .serve import verify_replay, verify_serve_trace
        diags.extend(verify_serve_trace(b.trace))
        if b.trace2:
            diags.extend(verify_replay(b.trace, b.trace2))
    return diags


# -- program layer ---------------------------------------------------------- #


@mutation("prg-oob-access", "prg.bounds")
def _mut_oob_access(b: Bundle):
    s = b.program.statements[0]
    off = tuple(o + 10_000 for o in s.rhs.offset)
    object.__setattr__(s.rhs, "offset", off)


@mutation("prg-unknown-dtype", "prg.dtype")
def _mut_unknown_dtype(b: Bundle):
    object.__setattr__(b.program.buffers[0], "dtype", "q7")


@mutation("prg-temp-read", "prg.temp-read")
def _mut_temp_read(b: Bundle):
    # Reclassify a pure input as a temp: now it is read before any write.
    written = {s.lhs.buffer for s in b.program.statements}
    inp = next(bu for bu in b.program.buffers if bu.name not in written)
    object.__setattr__(inp, "temp", True)


@mutation("prg-output-unwritten", "prg.output-unwritten")
def _mut_output_unwritten(b: Bundle):
    written = {s.lhs.buffer for s in b.program.statements}
    inp = next(bu.name for bu in b.program.buffers if bu.name not in written)
    object.__setattr__(b.program, "outputs", b.program.outputs + (inp,))


@mutation("prg-unknown-buffer", "prg.unknown-buffer")
def _mut_unknown_buffer(b: Bundle):
    object.__setattr__(b.program, "outputs", b.program.outputs + ("GHOST",))


# -- selection layer -------------------------------------------------------- #


@mutation("sel-uncover", "sel.coverage-gap")
def _mut_uncover(b: Bundle):
    m = b.selection.instrs[0].mapping
    object.__setattr__(m, "stmt_map", tuple(m.stmt_map)[:-1])


@mutation("sel-double-cover", "sel.coverage-overlap")
def _mut_double_cover(b: Bundle):
    m = b.selection.instrs[0].mapping
    object.__setattr__(m, "stmt_map",
                       tuple(m.stmt_map) + (m.stmt_map[0],))


@mutation("sel-axis-role", "sel.axis-role")
def _mut_axis_role(b: Bundle):
    m = b.selection.instrs[0].mapping
    amap = list(m.axis_map)
    amap[1] = (amap[1][0], amap[0][1])        # two needle axes -> one haystack
    object.__setattr__(m, "axis_map", tuple(amap))


@mutation("sel-buffer-map", "sel.buffer-map")
def _mut_buffer_map(b: Bundle):
    m = b.selection.instrs[0].mapping
    bmap = list(m.buffer_map)
    bmap[0] = (bmap[0][0], "GHOST")
    object.__setattr__(m, "buffer_map", tuple(bmap))


@mutation("sel-tile-cap", "sel.tile-cap")
def _mut_tile_cap(b: Bundle):
    class _Bad:
        tile_caps = (0, None, None)
        vmem_frac = 1.5
    b.approach = _Bad()


# -- schedule layer --------------------------------------------------------- #


def _first_op(sched, kind: str, pred=lambda op: True):
    return next(op for op in sched.ops if op.kind == kind and pred(op))


@mutation("sch-drop-copy", "sch.operand-missing")
def _mut_drop_copy(b: Bundle):
    sched = b.schedule
    victim = _first_op(sched, "copy",
                       lambda op: op.region.buffer not in sched.program.outputs)
    sched.ops = [op for op in sched.ops if op.uid != victim.uid]


@mutation("sch-stale-read", "sch.stale-read")
def _mut_stale_read(b: Bundle):
    # Re-issue the initial home->device copy of an output region *after* the
    # device has produced newer versions: the copy now reads home's stale v0.
    sched = b.schedule
    outs = set(sched.program.outputs)
    cp = _first_op(sched, "copy", lambda op: op.region.buffer in outs)
    last_w = max(i for i, op in enumerate(sched.ops)
                 if op.kind == "compute" and any(
                     w and r2.buffer == cp.region.buffer
                     and r2.bounds == cp.region.bounds
                     for _, r2, _, w in op.tile.operands))
    sched.ops = (list(sched.ops[:last_w + 1]) + [replace(cp, uid=9_000)]
                 + list(sched.ops[last_w + 1:]))


@mutation("sch-stale-writeback", "sch.stale-writeback")
def _mut_stale_writeback(b: Bundle):
    # Reroute the final writeback to *source* from the home memory, which
    # still holds the stale v0 base data.
    sched = b.schedule
    wb = [op for op in sched.ops if op.kind == "writeback"][-1]
    home = sched.homes[wb.region.buffer]
    idx = sched.ops.index(wb)
    sched.ops[idx] = replace(wb, src=home, dst=wb.src)


@mutation("sch-swap-ops", "sch.operand-missing")
def _mut_swap_ops(b: Bundle):
    # Hoist a compute above the copies that stage its operands.
    sched = b.schedule
    first_compute = _first_op(sched, "compute")
    rest = [op for op in sched.ops if op.uid != first_compute.uid]
    sched.ops = [first_compute] + rest


@mutation("sch-shrink-region", "sch.operand-missing")
def _mut_shrink_region(b: Bundle):
    sched = b.schedule
    cp = _first_op(sched, "copy")
    (start, span), *tail = cp.region.bounds
    shrunk = Region(cp.region.buffer,
                    ((start, max(1, span // 2)), *tail))
    idx = sched.ops.index(cp)
    sched.ops[idx] = replace(cp, region=shrunk)


@mutation("sch-unknown-device", "sch.unknown-node")
def _mut_unknown_device(b: Bundle):
    sched = b.schedule
    op = _first_op(sched, "compute")
    idx = sched.ops.index(op)
    sched.ops[idx] = replace(op, device="warp9")


@mutation("sch-inflate-region", "sch.capacity")
def _mut_inflate_region(b: Bundle):
    # Balloon one compute operand past any device memory capacity.
    sched = b.schedule
    op = _first_op(sched, "compute")
    buf, region, r, w = op.tile.operands[0]
    huge = Region(region.buffer,
                  tuple((s, 1 << 16) for s, _ in region.bounds))
    op.tile.operands[0] = (buf, huge, r, w)


@mutation("sch-bump-version", "sch.residency")
def _mut_bump_version(b: Bundle):
    sched = b.schedule
    k = next(iter(sched.final_residency))
    held = sched.final_residency[k]
    node = next(iter(held))
    held[node] += 1


@mutation("sch-drop-writeback", "sch.output-not-home")
def _mut_drop_writeback(b: Bundle):
    sched = b.schedule
    wb = [op for op in sched.ops if op.kind == "writeback"][-1]
    sched.ops = [op for op in sched.ops if op.uid != wb.uid]
    sched.final_residency.pop((wb.region.buffer, wb.region.bounds), None)


# -- incremental re-scheduling ---------------------------------------------- #


@mutation("inc-stale-stream", "sch.tile-mismatch", kind="incremental")
def _mut_inc_stale_stream(b: Bundle):
    # Resume one instruction too late: the parent's op stream for the
    # instruction whose tile actually changed is kept verbatim.  The splice
    # is *self-consistent* — every copy precedes its read, every version
    # chain checks out — so the sch.* replay stays silent; only recomputing
    # the expected tiling (verify_reschedule) can flag the stale reuse.
    from ..core.scheduler import schedule_incremental
    bad, _ = schedule_incremental(b.selection, b.sysgraph, b.approach,
                                  b.parent_schedule, b.segments,
                                  b.first_changed + 1)
    return (verify_schedule(bad, b.approach)
            + verify_reschedule(bad, b.selection, b.approach, b.sysgraph))


@mutation("inc-wrong-instr", "sch.residency", kind="incremental")
def _mut_inc_wrong_instr(b: Bundle):
    # Apply the delta at the wrong op boundary: keep the resume *state* of
    # the changed instruction but truncate the parent prefix short of it —
    # ops whose effects the state already claims never appear in the
    # stream, so the replayed residency disagrees with final_residency.
    from ..core.scheduler import schedule_incremental
    boundary, snap = b.segments[b.first_changed - 1]
    bad_segments = dict(b.segments)
    bad_segments[b.first_changed - 1] = (max(0, boundary - 4), snap)
    bad, _ = schedule_incremental(b.selection, b.sysgraph, b.approach,
                                  b.parent_schedule, bad_segments,
                                  b.first_changed)
    return (verify_schedule(bad, b.approach)
            + verify_reschedule(bad, b.selection, b.approach, b.sysgraph))


# -- fabric layer ----------------------------------------------------------- #


@mutation("fab-cycle", "fab.cycle", kind="fabric")
def _mut_fab_cycle(b: Bundle):
    from .fabric import verify_task_graph
    tid0, deps0 = b.tasks[0]
    b.tasks[0] = (tid0, deps0 + (b.tasks[-1][0],))
    return verify_task_graph(b.tasks)


@mutation("fab-duplicate-task", "fab.duplicate-task", kind="fabric")
def _mut_fab_dup(b: Bundle):
    from .fabric import verify_task_graph
    b.tasks.append(b.tasks[0])
    return verify_task_graph(b.tasks)


@mutation("fab-unknown-dep", "fab.unknown-dep", kind="fabric")
def _mut_fab_unknown_dep(b: Bundle):
    from .fabric import verify_task_graph
    tid0, deps0 = b.tasks[0]
    b.tasks[0] = (tid0, deps0 + ("ghost-task",))
    return verify_task_graph(b.tasks)


@mutation("fab-drop-step", "fab.unreachable", kind="fabric")
def _mut_fab_drop_step(b: Bundle):
    from .fabric import verify_collective
    steps = list(b.steps["all_gather"])
    steps.pop()
    return verify_collective("all_gather", steps, b.topo.n_chips)


@mutation("fab-chain-broken", "fab.chain-broken", kind="fabric")
def _mut_fab_chain(b: Bundle):
    from .fabric import verify_collective
    kind = ("reduce_scatter" if "reduce_scatter" in b.steps
            else "all_reduce")
    steps = [s for s in b.steps[kind] if not s.reduce or s.step != 0]
    return verify_collective(kind, steps, b.topo.n_chips)


@mutation("fab-drop-shard", "fab.contract", kind="fabric")
def _mut_fab_drop_shard(b: Bundle):
    from .fabric import verify_partition
    pp = b.partition
    object.__setattr__(pp, "shards", tuple(pp.shards)[:-1])
    return verify_partition(pp)


# -- graph layer ------------------------------------------------------------ #


@mutation("gra-cycle", "gra.cycle", kind="graph")
def _mut_gra_cycle(b: Bundle):
    # Rotate the last node to the front: it now consumes intermediates that
    # are only produced later.
    g = b.kgraph
    g.nodes = (g.nodes[-1],) + g.nodes[:-1]


@mutation("gra-shape-mismatch", "gra.shape", kind="graph")
def _mut_gra_shape(b: Bundle):
    g = b.kgraph
    t = g.nodes[0].produced()[0]
    spec = g.tensors[t]
    object.__setattr__(spec, "shape", tuple(s + 1 for s in spec.shape))


@mutation("gra-dtype-mismatch", "gra.dtype", kind="graph")
def _mut_gra_dtype(b: Bundle):
    g = b.kgraph
    t = g.nodes[0].produced()[0]
    object.__setattr__(g.tensors[t], "dtype", "bf16")


@mutation("gra-ghost-tensor", "gra.unknown-tensor", kind="graph")
def _mut_gra_ghost(b: Bundle):
    node = b.kgraph.nodes[0]
    (buf, _), *rest = node.inputs
    object.__setattr__(node, "inputs", ((buf, "GHOST"), *rest))


@mutation("gra-duplicate-producer", "gra.duplicate-producer", kind="graph")
def _mut_gra_dup_producer(b: Bundle):
    g = b.kgraph
    twin = copy.deepcopy(g.nodes[0])
    object.__setattr__(twin, "name", g.nodes[0].name + "_twin")
    g.nodes = g.nodes + (twin,)


@mutation("gra-node-program", "gra.node-program", kind="graph")
def _mut_gra_node_program(b: Bundle):
    # Corrupt one node's kernel program (out-of-bounds access): the prg.*
    # layer fires inside the graph sweep and surfaces as gra.node-program.
    s = b.kgraph.nodes[0].program.statements[0]
    object.__setattr__(s.rhs, "offset", tuple(o + 10_000 for o in s.rhs.offset))


@mutation("gra-over-budget", "gra.capacity", kind="graph")
def _mut_gra_over_budget(b: Bundle):
    b.locations = {t: "vmem" for t in b.locations}
    b.budget = 1


# -- serving layer ----------------------------------------------------------- #


@mutation("srv-over-admit", "srv.kv-budget", kind="serve")
def _mut_srv_over_admit(b: Bundle):
    # Pack every request into the busiest iteration's batch: the summed KV
    # footprint blows through the byte budget (and likely the batch cap).
    all_rids = [r["rid"] for r in b.trace["requests"]]
    b.trace["iterations"][0]["running"] = all_rids
    b.trace2 = {}


@mutation("srv-bucket-miss", "srv.bucket-route", kind="serve")
def _mut_srv_bucket_miss(b: Bundle):
    # Route a small prompt to the biggest bucket: a lattice miss served by
    # a wrong-shape artifact.
    req = min(b.trace["requests"], key=lambda r: r["prompt_len"])
    req["bucket"] = max(b.trace["buckets"])
    b.trace2 = {}


@mutation("srv-replay-drift", "srv.replay-drift", kind="serve")
def _mut_srv_replay_drift(b: Bundle):
    # Nudge one completion in the "frozen" twin: the replay no longer
    # reproduces the online run bit-for-bit.
    req = next(r for r in b.trace2["requests"]
               if r["completed"] is not None)
    req["completed"] += 1e-6


@mutation("srv-starve", "srv.starvation", kind="serve")
def _mut_srv_starve(b: Bundle):
    # A buggy policy never schedules the last request: wipe its admission
    # and scrub it from every iteration.
    victim = b.trace["requests"][-1]
    victim["admitted"] = victim["completed"] = None
    for itrec in b.trace["iterations"]:
        itrec["running"] = [r for r in itrec["running"]
                            if r != victim["rid"]]
        itrec["admitted"] = [r for r in itrec["admitted"]
                             if r != victim["rid"]]
    b.trace2 = {}


# -- artifact payloads ------------------------------------------------------ #


@mutation("art-missing-field", "art.schema")
def _mut_art_schema(b: Bundle):
    from .artifact import verify_artifact_dict
    del b.artifact["cost"]
    return verify_artifact_dict(b.artifact)


@mutation("art-bad-cost", "art.cost")
def _mut_art_cost(b: Bundle):
    from .artifact import verify_artifact_dict
    b.artifact["cost"] = float("inf")
    return verify_artifact_dict(b.artifact)


@mutation("art-bad-tile", "art.instr-plan")
def _mut_art_tile(b: Bundle):
    from .artifact import verify_artifact_dict
    plan = b.artifact["instrs"][0]
    plan["tile"] = [[axis, 0] for axis, _ in plan["tile"]]
    return verify_artifact_dict(b.artifact)


@mutation("art-bad-counts", "art.counts")
def _mut_art_counts(b: Bundle):
    from .artifact import verify_artifact_dict
    b.artifact["counts"] = {"copy": -3}
    return verify_artifact_dict(b.artifact)


# -- gpu target ------------------------------------------------------------- #


@mutation("gpu-smem-capacity", "sch.capacity", kind="gpu")
def _mut_gpu_smem_capacity(b: Bundle):
    # Shrink every shared-memory node below the tile working set: the
    # schedule that fit real cluster smem now claims more bytes than the
    # (corrupted) machine has — the replay must flag it, whatever the
    # staging memory is called on this target.
    g = b.schedule.graph
    for m in g.memories.values():
        if m.role == "staging":
            object.__setattr__(m, "capacity", 1024)


@mutation("gpu-wrong-lowering", "art.lowering-target", kind="gpu")
def _mut_gpu_wrong_lowering(b: Bundle):
    from .artifact import verify_artifact_dict
    # A tpu-shaped lowering config on a gpu-keyed artifact: the config an
    # artifact cache would serve if target families ever got crossed.
    b.artifact["lowering"] = {"kind": "pallas_gemm",
                              "block": b.artifact["lowering"]["block"],
                              "grid": b.artifact["lowering"]["grid"]}
    return verify_artifact_dict(b.artifact)


# --------------------------------------------------------------------------- #
# Runner
# --------------------------------------------------------------------------- #


@dataclass
class MutationResult:
    name: str
    expected: str
    caught: bool
    rules: list[str]

    def __str__(self) -> str:
        mark = "caught" if self.caught else "MISSED"
        return f"[{mark}] {self.name}: expected {self.expected}, " \
               f"got {sorted(set(self.rules)) or 'nothing'}"


_BUNDLES = {"gemm": _gemm_bundle, "gpu": _gpu_bundle,
            "fabric": _fabric_bundle,
            "graph": _graph_bundle, "serve": _serve_bundle,
            "incremental": _incremental_bundle}


def run_mutation(name: str) -> MutationResult:
    rule, kind, fn = MUTATIONS[name]
    bundle = _BUNDLES[kind]()
    diags = fn(bundle)
    if diags is None:                       # mutator corrupted in place
        diags = _verify_bundle(bundle)
    rules = [d.rule for d in diags]
    return MutationResult(name=name, expected=rule,
                          caught=rule in rules, rules=rules)


def run_all() -> list[MutationResult]:
    return [run_mutation(name) for name in MUTATIONS]


def baseline_report() -> DiagnosticReport:
    """The unmutated bundles must verify clean (no false positives)."""
    report = DiagnosticReport()
    report.extend(_verify_bundle(_gemm_bundle()))
    gb = _gpu_bundle()
    from .artifact import verify_artifact_dict
    report.extend(_verify_bundle(gb))
    report.extend(verify_artifact_dict(gb.artifact))
    fb = _fabric_bundle()
    from .fabric import verify_partition, verify_task_graph
    report.extend(verify_partition(fb.partition))
    report.extend(verify_task_graph(fb.tasks))
    report.extend(_verify_bundle(_graph_bundle()))
    report.extend(_verify_bundle(_serve_bundle()))
    report.extend(_verify_bundle(_incremental_bundle()))
    return report
