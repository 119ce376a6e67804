"""Layer 3 — schedule sanitizer (``sch.*`` rules).

Symbolically replays ``Schedule.ops`` over the same versioned-region state
machine the scheduler itself uses (``SchedulerState`` semantics, reusing
``_bounds_overlap``), checking every op against the residency the stream has
actually established:

  * a ``copy``/``writeback`` whose source does not hold the region
    (``sch.operand-missing``) or holds a stale version (``sch.stale-read`` /
    ``sch.stale-writeback``),
  * a ``compute`` whose read operand is not resident at its device memory in
    the latest version (RAW hazard),
  * a write that overlaps an unreconciled dirty region of another
    granularity (WAW/WAR hazard, ``sch.overlap-dirty``),
  * final outputs not home in the latest version, and ``final_residency``
    entries the replay disagrees with,
  * per-compute-tile operand working sets vs the device memory capacity
    (``sch.capacity``) and the approach's VMEM budget (``sch.vmem-budget``).

The replay is *optimistic about eviction*: the scheduler drops clean LRU
copies without emitting ops, so the replay never forgets a copy it has seen.
That can only under-report residency hazards on evicted copies — it can
never flag a correct schedule (no false positives), which is the property
the mutation harness + golden suites pin down.
"""
from __future__ import annotations

from collections import Counter

from ..core.scheduler import Region, Schedule, _bounds_overlap
from .diagnostics import Diagnostic, diag


class _Replay:
    """Versioned-copy state mirroring ``SchedulerState`` (minus eviction)."""

    def __init__(self, sched: Schedule):
        self.sched = sched
        self.prog = sched.program
        self.homes = sched.homes
        self.latest: dict[tuple, int] = {}
        self.copies: dict[tuple, dict[str, int]] = {}
        self._dtypes = {b.name: b.dtype for b in self.prog.buffers}

    @staticmethod
    def key(region: Region) -> tuple:
        return (region.buffer, region.bounds)

    def nbytes(self, region: Region) -> int:
        return region.nbytes(self._dtypes.get(region.buffer, "f32"))

    def held_version(self, node: str, region: Region) -> int | None:
        """Version of ``region`` held at ``node``.

        The home memory implicitly holds v0 until a writeback commits a
        newer version there — that is physically true (the base data sits
        in the home buffer), so a read from home after uncommitted writes
        is a *stale* read, not a missing operand."""
        k = self.key(region)
        v = self.copies.get(k, {}).get(node)
        if v is None and self.homes.get(region.buffer) == node:
            return 0
        return v

    def install(self, node: str, region: Region, version: int):
        self.copies.setdefault(self.key(region), {})[node] = version

    def write(self, node: str, region: Region):
        """Mirror ``SchedulerState.install(dirty=True)`` + overlap invalidation.

        Unlike the scheduler, other nodes' same-key entries are *kept* at
        their old versions: the scheduler drops those copies, but every read
        it serves is preceded by an in-stream install of the latest version,
        so remembering the stale ones cannot flag a correct schedule — it
        only lets a mutated stream report ``sch.stale-read`` (version N vs
        latest M) instead of the less precise ``sch.operand-missing``."""
        k = self.key(region)
        v = self.latest.get(k, 0) + 1
        self.latest[k] = v
        self.copies.setdefault(k, {})[node] = v
        home = self.homes.get(region.buffer)
        for k2 in list(self.copies):
            if k2 == k or k2[0] != region.buffer:
                continue
            if not _bounds_overlap(k2[1], region.bounds):
                continue
            held = self.copies[k2]
            for n in list(held):
                if n != home:
                    held.pop(n)

    def overlapping_dirty(self, region: Region) -> list[tuple]:
        """Intersecting other-granularity keys with uncommitted writes."""
        k = self.key(region)
        home = self.homes.get(region.buffer)
        out = []
        for k2, held in self.copies.items():
            if k2 == k or k2[0] != region.buffer:
                continue
            v2 = self.latest.get(k2, 0)
            if v2 == 0 or held.get(home) == v2:
                continue
            if _bounds_overlap(k2[1], region.bounds):
                out.append(k2)
        return out


def verify_schedule(sched: Schedule, approach=None) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    rp = _Replay(sched)

    for op in sched.ops:
        if op.kind in ("copy", "writeback"):
            diags.extend(_check_move(rp, op))
        elif op.kind == "compute":
            diags.extend(_check_compute(rp, op, approach))
        else:
            diags.append(diag(
                "sch.unknown-node", f"op {op.uid} has unknown kind "
                f"{op.kind!r}", subject=op.kind, uid=op.uid))

    diags.extend(_check_final_state(rp))
    return diags


def verify_reschedule(sched: Schedule, selection, approach,
                      graph=None) -> list[Diagnostic]:
    """Check a schedule's compute tiles against what ``approach`` resolves
    for ``selection`` from scratch (``sch.tile-mismatch``).

    This closes the one hole incremental re-scheduling opens that the
    replay above cannot see: a stale-stream splice — a resumed schedule
    that kept a parent's ops for an instruction whose tile changed — is
    *self-consistent* (every copy precedes its read, every version chain
    checks out), it just computes the wrong tiling.  Only recomputing the
    expected per-instruction tile multiset can flag it.  Comparison is by
    multiset of (offsets, sizes) per ``instr_idx``, so it is independent of
    unroll order and of which device each tile landed on."""
    g = graph if graph is not None else sched.graph
    from ..core.scheduler import Scheduler

    def tkey(t) -> tuple:
        return (tuple(sorted(t.offsets.items())),
                tuple(sorted(t.sizes.items())))

    try:
        sch = Scheduler(selection, g, approach)
        expected: dict[int, Counter] = {}
        for idx, si in enumerate(selection.instrs):
            devices = g.compute_nodes_for(si.needle.name)
            if not devices:
                return []    # unschedulable selection: nothing to compare
            expected[idx] = Counter(
                tkey(t) for t in
                sch._tiles_for(idx, si, devices[0].matmul_tile))
    except Exception:
        return []            # expectation not computable — not this rule
    got: dict[int, Counter] = {idx: Counter() for idx in expected}
    for op in sched.ops:
        if op.kind != "compute" or op.tile is None:
            continue
        got.setdefault(op.tile.instr_idx, Counter())[tkey(op.tile)] += 1

    diags: list[Diagnostic] = []
    for idx in sorted(got):
        e = expected.get(idx)
        if e is None:
            diags.append(diag(
                "sch.tile-mismatch",
                f"compute ops reference instruction {idx}, which the "
                f"selection does not have", subject=str(idx)))
            continue
        if e != got[idx]:
            missing = sum((e - got[idx]).values())
            extra = sum((got[idx] - e).values())
            diags.append(diag(
                "sch.tile-mismatch",
                f"instruction {idx}: schedule's compute tiles do not match "
                f"the approach's resolved tiling ({missing} expected "
                f"tile(s) missing, {extra} unexpected — stale incremental "
                f"reuse?)", subject=str(idx)))
    return diags


def _check_move(rp: _Replay, op) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    g = rp.sched.graph
    region = op.region
    k = rp.key(region)
    for node in (op.src, op.dst):
        if node not in g.memories:
            diags.append(diag(
                "sch.unknown-node",
                f"{op.kind} {op.uid} references unknown memory node "
                f"{node!r}", subject=node, uid=op.uid))
            return diags
    try:
        g.edge(op.src, op.dst)
    except KeyError:
        diags.append(diag(
            "sch.unknown-node",
            f"{op.kind} {op.uid} moves {region.buffer} over nonexistent "
            f"edge {op.src}->{op.dst}", subject=op.src, uid=op.uid))
    if region.buffer not in rp.homes:
        diags.append(diag(
            "sch.unknown-node",
            f"{op.kind} {op.uid}: no home memory recorded for buffer "
            f"{region.buffer!r}", subject=region.buffer, uid=op.uid))
        return diags

    latest = rp.latest.get(k, 0)
    held = rp.held_version(op.src, region)
    if held is None:
        diags.append(diag(
            "sch.operand-missing",
            f"{op.kind} {op.uid} reads {region.buffer}{region.bounds} at "
            f"{op.src}, which holds no copy of it", subject=op.src,
            uid=op.uid))
    elif held != latest:
        rule = ("sch.stale-writeback" if op.kind == "writeback"
                else "sch.stale-read")
        diags.append(diag(
            rule,
            f"{op.kind} {op.uid} moves version {held} of "
            f"{region.buffer}{region.bounds} from {op.src} but latest is "
            f"{latest}", subject=op.src, uid=op.uid))
    # Install the latest version at dst regardless, so one corruption does
    # not cascade into a diagnostic per downstream consumer.
    rp.install(op.dst, region, latest)
    return diags


def _check_compute(rp: _Replay, op, approach) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    g = rp.sched.graph
    tile = op.tile
    dev = g.computes.get(op.device)
    if dev is None:
        diags.append(diag(
            "sch.unknown-node",
            f"compute {op.uid} runs on unknown device {op.device!r}",
            subject=op.device, uid=op.uid))
        return diags
    if not dev.executes(tile.needle_name):
        diags.append(diag(
            "sch.device-instr",
            f"compute {op.uid}: device {dev.name} does not execute "
            f"{tile.needle_name}", subject=dev.name, uid=op.uid))
    mem = dev.memory

    # Working set (distinct operand regions) must fit the device memory;
    # the scheduler pins exactly this set while the tile runs.
    distinct: dict[tuple, int] = {}
    for _, region, _, _ in tile.operands:
        distinct.setdefault(rp.key(region), rp.nbytes(region))
    working = sum(distinct.values())
    mnode = g.memories.get(mem)
    cap = mnode.capacity if mnode is not None else None
    # budget against whatever the target's compute-adjacent tier is called
    # (TPU VMEM, GPU shared memory, register files) — the memory *role*,
    # not a well-known node name.
    role = getattr(mnode, "role", "staging") if mnode is not None \
        else "staging"
    if cap is None:
        diags.append(diag(
            "sch.unknown-node",
            f"compute {op.uid}: device {dev.name} uses unknown memory "
            f"{mem!r}", subject=mem, uid=op.uid))
    elif working > cap:
        diags.append(diag(
            "sch.capacity",
            f"compute {op.uid} ({tile.needle_name}): operand working set "
            f"{working} bytes exceeds {role} memory {mem} capacity {cap}",
            subject=mem, uid=op.uid))
    elif approach is not None:
        frac = getattr(approach, "vmem_frac", 1.0)
        if 0.0 < frac < 1.0 and working > cap * frac:
            diags.append(diag(
                "sch.vmem-budget",
                f"compute {op.uid} ({tile.needle_name}): working set "
                f"{working} bytes exceeds vmem_frac {frac} of {role} "
                f"memory {mem} capacity {cap}", severity="warning",
                subject=mem, uid=op.uid))

    for _, region, r, w in tile.operands:
        if region.buffer not in rp.homes:
            diags.append(diag(
                "sch.unknown-node",
                f"compute {op.uid}: no home memory recorded for buffer "
                f"{region.buffer!r}", subject=region.buffer, uid=op.uid))
            continue
        k = rp.key(region)
        latest = rp.latest.get(k, 0)
        if r:
            held = rp.held_version(mem, region)
            if held is None:
                diags.append(diag(
                    "sch.operand-missing",
                    f"compute {op.uid} ({tile.needle_name}) reads "
                    f"{region.buffer}{region.bounds} at {mem}, which holds "
                    f"no copy of it (RAW hazard)", subject=mem, uid=op.uid))
            elif held != latest:
                diags.append(diag(
                    "sch.stale-read",
                    f"compute {op.uid} ({tile.needle_name}) reads version "
                    f"{held} of {region.buffer}{region.bounds} at {mem} "
                    f"but latest is {latest} (RAW hazard)",
                    subject=mem, uid=op.uid))
            rp.install(mem, region, latest)   # de-cascade
        else:
            # write-only operands are installed in place by the scheduler
            rp.install(mem, region, latest)
        if w:
            for k2 in rp.overlapping_dirty(region):
                diags.append(diag(
                    "sch.overlap-dirty",
                    f"compute {op.uid} writes {region.buffer}"
                    f"{region.bounds} while overlapping dirty region "
                    f"{k2[1]} was never reconciled home (WAW/WAR hazard)",
                    subject=region.buffer, uid=op.uid))
    for _, region, r, w in tile.operands:
        if w and region.buffer in rp.homes:
            rp.write(mem, region)
    return diags


def _check_final_state(rp: _Replay) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    sched = rp.sched

    # final_residency must agree with the replayed state (it may be a
    # subset: clean LRU evictions drop entries without emitting ops).
    for k, held in sched.final_residency.items():
        for node, ver in held.items():
            got = rp.copies.get(k, {}).get(node)
            if got is None and ver == 0 and rp.homes.get(k[0]) == node:
                got = 0
            if got != ver:
                diags.append(diag(
                    "sch.residency",
                    f"final_residency claims {node} holds version {ver} of "
                    f"{k[0]}{k[1]}, but the op stream leaves "
                    f"{'no copy' if got is None else f'version {got}'} "
                    f"there", subject=node))

    # every written output region must end at its home in the latest version
    outputs = set(sched.program.outputs)
    for k, v in rp.latest.items():
        buf = k[0]
        if buf not in outputs or v == 0:
            continue
        home = rp.homes.get(buf)
        if home is None:
            continue
        if rp.copies.get(k, {}).get(home) != v:
            diags.append(diag(
                "sch.output-not-home",
                f"output region {buf}{k[1]} ends at version {v} but home "
                f"{home} holds "
                f"{rp.copies.get(k, {}).get(home, 'no copy')}",
                subject=buf))
    return diags
