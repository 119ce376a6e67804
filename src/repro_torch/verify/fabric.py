"""Layer 4 — fabric checker (``fab.*`` rules).

Validates the distributed layer statically:

  * **task graphs** — ``EventSim`` task lists (or any ``(tid, deps)``
    pairs) must have unique ids, known deps, and be acyclic; a cycle or a
    dangling dep would hang or silently drop work in a relaxation replay.
  * **collective plans** — lowered ``CollectiveStep`` lists must form
    unbroken per-(direction, chunk) chains; an all-gather must deliver
    every chunk to every chip, a reduce must fold exactly ``p - 1`` hops
    per chunk.
  * **partition contract** — shard chips are dense, shard outputs
    reassemble the global output (``concat``: extents along the output
    axis sum; ``chain_sum``: full-size partials), collective chunks tile
    the buffer extent.

Imports from ``repro_torch.fabric`` are deferred into the functions — the fabric
package imports ``repro_torch.compile`` which (via cached-artifact checks) imports
``repro_torch.verify``.
"""
from __future__ import annotations

from .diagnostics import Diagnostic, diag


def _as_dep_pairs(tasks) -> list[tuple[str, tuple[str, ...]]]:
    """Accept an EventSim, its ``_Task`` list, or raw (tid, deps) pairs."""
    if hasattr(tasks, "_tasks"):            # EventSim
        tasks = tasks._tasks
    out = []
    for t in tasks:
        if isinstance(t, tuple):
            tid, deps = t[0], t[1]
        else:
            tid, deps = t.tid, t.deps
        out.append((str(tid), tuple(deps)))
    return out


def verify_task_graph(tasks) -> list[Diagnostic]:
    """Unique ids, known deps, acyclic, fully reachable (Kahn's algorithm)."""
    diags: list[Diagnostic] = []
    pairs = _as_dep_pairs(tasks)
    known: set[str] = set()
    for tid, _ in pairs:
        if tid in known:
            diags.append(diag(
                "fab.duplicate-task", f"task id {tid!r} appears more than "
                f"once", subject=tid))
        known.add(tid)

    indeg: dict[str, int] = {tid: 0 for tid, _ in pairs}
    succs: dict[str, list[str]] = {tid: [] for tid, _ in pairs}
    for tid, deps in pairs:
        for d in deps:
            if d not in known:
                diags.append(diag(
                    "fab.unknown-dep",
                    f"task {tid!r} depends on unknown task {d!r}",
                    subject=tid))
                continue
            indeg[tid] += 1
            succs[d].append(tid)

    ready = [tid for tid, n in indeg.items() if n == 0]
    seen = 0
    while ready:
        tid = ready.pop()
        seen += 1
        for s in succs[tid]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if seen < len(indeg):
        stuck = sorted(tid for tid, n in indeg.items() if n > 0)
        diags.append(diag(
            "fab.cycle",
            f"{len(stuck)} task(s) unreachable behind a dependency cycle "
            f"(e.g. {stuck[:3]})", subject=stuck[0] if stuck else ""))
    return diags


def verify_collective(kind: str, steps, p: int) -> list[Diagnostic]:
    """Chain linkage + delivery coverage of a lowered collective plan."""
    diags: list[Diagnostic] = []
    if p <= 1:
        if steps:
            diags.append(diag(
                "fab.chain-broken",
                f"{kind}: {len(steps)} step(s) lowered for a 1-chip fabric",
                subject=kind))
        return diags

    chains: dict[tuple[int, int], list] = {}
    for st in steps:
        for chip in (st.src, st.dst):
            if not (0 <= chip < p):
                diags.append(diag(
                    "fab.contract",
                    f"{kind}: step {st.step} references chip {chip} outside "
                    f"[0, {p - 1}]", subject=kind, uid=st.step))
        chains.setdefault((st.direction, st.chunk), []).append(st)

    for (direction, chunk), chain in sorted(chains.items()):
        chain.sort(key=lambda s: s.step)
        for a, b in zip(chain, chain[1:]):
            if a.dst != b.src:
                diags.append(diag(
                    "fab.chain-broken",
                    f"{kind}: chunk {chunk} dir {direction} hops "
                    f"{a.src}->{a.dst} then {b.src}->{b.dst}; the chain is "
                    f"broken at step {b.step}", subject=kind, uid=b.step))
        n_reduce = sum(1 for s in chain if s.reduce)
        if kind in ("reduce_scatter", "all_reduce") and n_reduce != p - 1:
            diags.append(diag(
                "fab.chain-broken",
                f"{kind}: chunk {chunk} dir {direction} reduced over "
                f"{n_reduce} hop(s), expected {p - 1}",
                subject=kind, uid=chunk))

    if kind == "all_gather":
        # chunk c starts on chip c; every chip must end up possessing it
        possession = {i: {i} for i in range(p)}
        by_step: dict[int, list] = {}
        for st in steps:
            by_step.setdefault(st.step, []).append(st)
        for s in sorted(by_step):
            received = []
            for st in by_step[s]:
                if st.chunk not in possession.get(st.src, set()):
                    diags.append(diag(
                        "fab.unreachable",
                        f"{kind}: step {s} sends chunk {st.chunk} from chip "
                        f"{st.src}, which never received it",
                        subject=kind, uid=s))
                received.append((st.dst, st.chunk))
            for dst, chunk in received:
                possession.setdefault(dst, set()).add(chunk)
        missing = [(i, c) for i in range(p) for c in range(p)
                   if c not in possession.get(i, set())]
        for i, c in missing:
            diags.append(diag(
                "fab.unreachable",
                f"{kind}: chip {i} never receives chunk {c}",
                subject=kind, uid=c))
    return diags


def verify_partition(pp) -> list[Diagnostic]:
    """Sharded-output contract of a ``PartitionedProgram``."""
    diags: list[Diagnostic] = []
    base = pp.base
    out = pp.output
    out_shape = base.buffer(out).shape

    chips = sorted(s.chip for s in pp.shards)
    if chips != list(range(pp.n_chips)):
        diags.append(diag(
            "fab.contract",
            f"shard chips {chips} are not exactly 0..{pp.n_chips - 1}",
            subject=pp.axis))
        return diags

    if pp.out_mode == "chain_sum":
        for s in pp.shards:
            got = s.program.buffer(out).shape
            if got != out_shape:
                diags.append(diag(
                    "fab.contract",
                    f"chain_sum shard {s.chip}: partial output shape {got} "
                    f"!= global {out_shape}", subject=out, uid=s.chip))
    else:
        total = 0
        for s in sorted(pp.shards, key=lambda s: s.chip):
            shp = s.program.buffer(out).shape
            total += shp[pp.out_axis]
            for d, (a, b) in enumerate(zip(shp, out_shape)):
                if d != pp.out_axis and a != b:
                    diags.append(diag(
                        "fab.contract",
                        f"concat shard {s.chip}: output dim {d} is {a}, "
                        f"global is {b}", subject=out, uid=s.chip))
        if total != out_shape[pp.out_axis]:
            diags.append(diag(
                "fab.contract",
                f"concat shards cover {total} of output axis "
                f"{pp.out_axis} extent {out_shape[pp.out_axis]}",
                subject=out))

    for spec in pp.collectives:
        ext = base.buffer(spec.buffer).shape[spec.axis]
        off = 0
        for i, (o, ln) in enumerate(spec.chunks):
            if o != off or ln <= 0:
                diags.append(diag(
                    "fab.contract",
                    f"{spec.kind} on {spec.buffer}: chunk {i} is "
                    f"({o}, {ln}), expected contiguous from {off}",
                    subject=spec.buffer, uid=i))
                break
            off += ln
        else:
            if off != ext:
                diags.append(diag(
                    "fab.contract",
                    f"{spec.kind} on {spec.buffer}: chunks cover {off} of "
                    f"axis {spec.axis} extent {ext}", subject=spec.buffer))
        if len(spec.chunks) != pp.n_chips:
            diags.append(diag(
                "fab.contract",
                f"{spec.kind} on {spec.buffer}: {len(spec.chunks)} chunks "
                f"for {pp.n_chips} chips", subject=spec.buffer))
    return diags


def verify_fabric(pp, topo, approach=None, algorithm: str = "ring",
                  chip_graph=None) -> list[Diagnostic]:
    """Full distributed check: partition contract, lowered collectives,
    the assembled ``EventSim`` task graph, and every distinct per-chip
    compile through the program/selection/schedule layers."""
    from ..compile import compile_selection
    from ..fabric.simulate import _lower, simulate_partition
    from .program import verify_program
    from .schedule import verify_schedule
    from .selection import verify_selection

    diags = verify_partition(pp)
    for spec in pp.collectives:
        steps = _lower(spec, pp, topo, algorithm)
        diags.extend(verify_collective(spec.kind, steps, topo.n_chips))

    sim_out: list = []
    simulate_partition(pp, topo, approach, algorithm, chip_graph,
                       sim_out=sim_out)
    for sim in sim_out:
        diags.extend(verify_task_graph(sim))

    seen: set[str] = set()
    for shard in pp.shards:
        sig = shard.program.signature()
        if sig in seen:
            continue
        seen.add(sig)
        sel = pp.shard_selection(shard)
        art = compile_selection(sel, chip_graph or _default_chip_graph(),
                                approach)
        diags.extend(verify_program(sel.program))
        diags.extend(verify_selection(sel, approach))
        diags.extend(verify_schedule(art.schedule, approach))
    return diags


def _default_chip_graph():
    from ..fabric.topology import Topology
    return Topology.chip_graph()
