"""Static "dry-run" scheduler (paper Section 3).

Given an instruction Selection (isel.py), a SystemGraph (sysgraph.py) and an
Approach (approach.py), the scheduler performs a simulated execution of the
program, recording the instruction stream each device must execute:

  1. **Unrolling** (3.3)     — each selected instruction is tiled over its
     outer axes and over hardware tile shapes on the mapped axes, producing
     *compute tiles*; the Approach orders them (dependency order).
  2. **Device allocation** (3.4) — each tile is assigned to a compute node.
  3. **Memory movement** (3.5)  — buffer regions are tracked as versioned
     copies across memory nodes; reads route from the best existing copy via
     the movement graph (intermediate copies become cached copies); writes
     perform virtual *cache invalidation* of stale copies; capacity overflow
     triggers LRU eviction with dirty write-back.

The emitted ``Schedule`` carries COPY / COMPUTE ops with full region info.
``cost_model()`` replays the stream on per-resource timelines (DMA engines
overlap with compute) to produce modeled seconds/cycles — the "profile" used
by the benchmarks and by CostModelApproach.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field


from .approach import Approach, GreedyApproach
from .dtypes import DTYPE_BYTES  # noqa: F401  (re-exported; one shared table)
from .ir import Program
from .isel import SelectedInstr, Selection
from .sysgraph import ComputeNode, SystemGraph

# --------------------------------------------------------------------------- #
# Regions and tiles
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Region:
    """A rectangular region of a buffer: (start, size) per dimension."""

    buffer: str
    bounds: tuple[tuple[int, int], ...]

    def nbytes(self, dtype: str = "f32") -> int:
        n = 1
        for _, s in self.bounds:
            n *= s
        return n * DTYPE_BYTES.get(dtype, 4)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(s for _, s in self.bounds)


@dataclass
class ComputeTile:
    """One instruction invocation: a tile of a SelectedInstr's iteration
    space.  ``offsets``/``sizes`` cover every haystack axis in the
    instruction's window domain; operands are (needle buffer, region,
    reads, writes) in needle-buffer order."""

    instr_idx: int
    needle_name: str
    offsets: dict[str, int]
    sizes: dict[str, int]
    operands: list[tuple[str, Region, bool, bool]]  # (needle buf, region, r, w)
    device: str = ""

    def output_region(self) -> Region | None:
        for _, reg, _, w in self.operands:
            if w:
                return reg
        return None

    def out_key(self):
        r = self.output_region()
        return (r.buffer, r.bounds) if r else ("", ())

    def red_key(self):
        """Offsets on non-output axes (reduction/outer) — orders k-innermost."""
        return tuple(sorted(self.offsets.items()))

    def flops(self) -> float:
        if self.needle_name.startswith(("mxu.", "fused.")):
            n = 1
            for s in self.sizes.values():
                n *= s
            return 2.0 * n
        n = 1
        for s in self.sizes.values():
            n *= s
        return float(n)


@dataclass
class ScheduledOp:
    uid: int
    kind: str                      # 'copy' | 'compute' | 'writeback'
    device: str                    # issuing compute node (or 'host')
    # copy / writeback:
    src: str = ""
    dst: str = ""
    region: Region | None = None
    # compute:
    tile: ComputeTile | None = None
    # filled by cost model:
    start: float = 0.0
    end: float = 0.0

    def describe(self) -> str:  # pragma: no cover - debugging aid
        if self.kind == "compute":
            return (f"[{self.device}] {self.tile.needle_name} "
                    f"@{self.tile.offsets} x{self.tile.sizes}")
        return (f"[{self.device}] {self.kind} {self.region.buffer}"
                f"{self.region.bounds} {self.src}->{self.dst}")


@dataclass
class Schedule:
    program: Program
    graph: SystemGraph
    ops: list[ScheduledOp]
    final_residency: dict          # (buffer, bounds) -> {node: version}
    homes: dict[str, str]
    makespan: float = 0.0
    device_busy: dict[str, float] = field(default_factory=dict)

    def counts(self) -> dict[str, int]:
        c: dict[str, int] = {}
        for op in self.ops:
            c[op.kind] = c.get(op.kind, 0) + 1
        return c

    def region_nbytes(self, region: Region) -> int:
        """Byte size of a region under its buffer's declared dtype (regions
        themselves are dtype-blind element ranges)."""
        try:
            dtype = self.program.buffer(region.buffer).dtype
        except KeyError:
            dtype = "f32"
        return region.nbytes(dtype)

    def bytes_moved(self) -> int:
        return sum(self.region_nbytes(op.region) for op in self.ops
                   if op.kind in ("copy", "writeback"))


# --------------------------------------------------------------------------- #
# Scheduler state: versioned region copies across memory nodes
# --------------------------------------------------------------------------- #


def _bounds_overlap(b1: tuple, b2: tuple) -> bool:
    if len(b1) != len(b2):
        return False
    for (s1, n1), (s2, n2) in zip(b1, b2):
        if s1 >= s2 + n2 or s2 >= s1 + n1:
            return False
    return True


class SchedulerState:
    """The 'critical objects which interact during the scheduling process by
    retaining the system state' (paper 3.2).

    Buffer contents are tracked as *versioned region copies* across memory
    nodes.  Because different instructions may tile the same buffer at
    different granularities, overlapping region keys are kept coherent by a
    reconcile-to-home protocol: before a read (or an overlapping write), any
    intersecting dirty region is written back to the buffer's home memory,
    which then serves as the authoritative merge point.  Writes perform the
    paper's virtual cache invalidation on every stale copy.
    """

    def __init__(self, graph: SystemGraph, homes: dict[str, str],
                 dtypes: dict[str, str] | None = None):
        self.graph = graph
        self.homes = homes                      # buffer -> home memory node
        self.dtypes = dict(dtypes or {})        # buffer -> dtype
        self.version: dict[tuple, int] = {}     # region key -> latest version
        # region key -> {memory node -> version held}
        self.copies: dict[tuple, dict[str, int]] = {}
        self.used: dict[str, int] = {m: 0 for m in graph.memories}
        self.lru: dict[tuple[str, tuple], int] = {}   # (node, region key)
        self.clock = 0
        self.device_load: dict[str, float] = {}

    def clone(self) -> "SchedulerState":
        """Cheap structural copy for segment snapshots: the immutable
        context (graph, homes, dtypes) is shared, every mutable table is
        copied one level deep (``copies`` two levels: its values are
        per-node version dicts).  ``copy.deepcopy`` would also clone the
        SystemGraph — ~1000x the work for the incremental scheduler's
        per-instruction snapshots."""
        s = SchedulerState.__new__(SchedulerState)
        s.graph = self.graph
        s.homes = self.homes
        s.dtypes = self.dtypes
        s.version = dict(self.version)
        s.copies = {k: dict(v) for k, v in self.copies.items()}
        s.used = dict(self.used)
        s.lru = dict(self.lru)
        s.clock = self.clock
        s.device_load = dict(self.device_load)
        # round_robin's per-run cursor lives on the state (approach.py), so
        # a resumed suffix continues the rotation exactly where the parent
        # run stood at the snapshot.
        s._rr_cursor = getattr(self, "_rr_cursor", 0)
        return s

    # -- region bookkeeping ---------------------------------------------------
    @staticmethod
    def key(region: Region) -> tuple:
        return (region.buffer, region.bounds)

    def nbytes(self, region: Region) -> int:
        """Region size under the owning buffer's dtype (f32 when unknown)."""
        return region.nbytes(self.dtypes.get(region.buffer, "f32"))

    def holders(self, region: Region) -> dict[str, int]:
        """Memory nodes holding the LATEST version of this region.  The home
        node implicitly holds version 0 of everything."""
        k = self.key(region)
        v = self.version.get(k, 0)
        held = {n: ver for n, ver in self.copies.get(k, {}).items() if ver == v}
        if v == 0:
            held.setdefault(self.homes[region.buffer], 0)
        return held

    def holds_region(self, node: str, region: Region | None) -> bool:
        if region is None:
            return False
        return node in self.holders(region)

    def touch(self, node: str, region: Region):
        self.clock += 1
        self.lru[(node, self.key(region))] = self.clock

    def _add_copy(self, node: str, region: Region, version: int):
        k = self.key(region)
        holders = self.copies.setdefault(k, {})
        if node not in holders:
            self.used[node] = self.used.get(node, 0) + self.nbytes(region)
        holders[node] = version
        self.touch(node, region)

    def install(self, node: str, region: Region, dirty: bool = False):
        k = self.key(region)
        if dirty:
            v = self.version.get(k, 0) + 1      # cache invalidation
            self.version[k] = v
            for stale in list(self.copies.get(k, {})):
                if stale != node:
                    self.drop(stale, k)
            self._add_copy(node, region, v)
        else:
            self._add_copy(node, region, self.version.get(k, 0))

    def drop(self, node: str, region_key: tuple):
        holders = self.copies.get(region_key, {})
        if node in holders:
            holders.pop(node)
            self.used[node] -= self.nbytes(Region(*region_key))
        self.lru.pop((node, region_key), None)

    def overlapping_dirty(self, region: Region,
                          include_exact: bool = False) -> list[tuple]:
        """Keys of regions intersecting ``region`` with uncommitted writes
        (version > 0 not present at home)."""
        k = self.key(region)
        home = self.homes[region.buffer]
        out = []
        for k2, holders in self.copies.items():
            if k2[0] != region.buffer or (k2 == k and not include_exact):
                continue
            v2 = self.version.get(k2, 0)
            if v2 == 0 or holders.get(home) == v2:
                continue
            if _bounds_overlap(k2[1], region.bounds):
                out.append(k2)
        return out


# --------------------------------------------------------------------------- #
# The scheduler
# --------------------------------------------------------------------------- #


class ScheduleError(RuntimeError):
    pass


class Scheduler:
    def __init__(self, selection: Selection, graph: SystemGraph,
                 approach: Approach | None = None,
                 state: SchedulerState | None = None):
        self.sel = selection
        self.prog = selection.program
        self.graph = graph
        self.approach = approach or GreedyApproach()
        if selection.uncovered:
            raise ScheduleError(
                f"selection leaves statements uncovered: {selection.uncovered}")
        self.homes = state.homes if state else {
            b.name: self.approach.choose_home(
                b.name, self._buffer_bytes(b.name), graph)
            for b in self.prog.buffers if not b.temp or self._materialized(b.name)}
        self.state = state or SchedulerState(
            graph, self.homes, dtypes={b.name: b.dtype
                                       for b in self.prog.buffers})
        self.ops: list[ScheduledOp] = []
        self._uid = 0
        # instr idx -> (op count, state snapshot) taken right after the last
        # tile of that instruction retired; filled by
        # run_body(record_segments=True) and consumed by schedule_incremental.
        self.segments: dict[int, tuple[int, SchedulerState]] = {}

    # -- helpers ------------------------------------------------------------
    def _buffer_bytes(self, name: str) -> int:
        b = self.prog.buffer(name)
        n = 1
        for s in b.shape:
            n *= s
        return n * DTYPE_BYTES.get(b.dtype, 4)

    def _materialized(self, name: str) -> bool:
        """Temps that survive instruction selection (inter-instruction temps
        like the factored U buffer) are materialized; needle-internal chain
        temps are not."""
        b = self.prog.buffer(name)
        if not b.temp:
            return True
        for si in self.sel.instrs:
            bm = dict(si.mapping.buffer_map)
            # buffer appears as a *non-temp* needle operand -> materialized
            for nb in si.needle.buffers:
                if bm.get(nb.name) == name and not nb.temp:
                    return True
        return False

    def _emit(self, **kw) -> ScheduledOp:
        op = ScheduledOp(uid=self._uid, **kw)
        self._uid += 1
        self.ops.append(op)
        return op

    # -- tiling (Section 3.3) --------------------------------------------------
    def _needle_axis_roles(self, si: SelectedInstr) -> dict[str, str]:
        """needle axis name -> haystack axis name."""
        return {na: ha for na, ha in si.mapping.axis_map}

    def _tiles_for(self, idx: int, si: SelectedInstr,
                   device_tile: tuple[int, int, int]) -> list[ComputeTile]:
        m = si.mapping
        axis_map = dict(m.axis_map)           # needle axis -> haystack axis
        mapped_h = {h: n for n, h in axis_map.items()}

        # Extents of the window domain axes.
        window_axes: list[str] = []
        for hi in m.stmt_map:
            s = self.prog.statements[hi]
            for acc in (s.lhs, s.rhs):
                for a in acc.axes_used(self.prog.axis_names):
                    if a not in window_axes:
                        window_axes.append(a)

        devices = self.graph.compute_nodes_for(si.needle.name)
        tile_req = self.approach.choose_tile_shape(
            si.needle.name,
            {na: self.prog.axis(ha).size for na, ha in axis_map.items()},
            device_tile,
            vmem_budget=self.graph.staging_budget(devices) if devices
            else None)

        # Per-axis tile size: mapped axes tile by hardware shape, outer axes
        # advance one point per call — except for pure elementwise
        # instructions, where foldable outer axes coalesce into one call
        # (one long vector op instead of thousands of tiny ones).
        foldable = self._foldable_outer(si, window_axes, mapped_h)
        tile_sz: dict[str, int] = {}
        for a in window_axes:
            if a in mapped_h:
                tile_sz[a] = max(1, min(tile_req.get(mapped_h[a], 1 << 30),
                                        self.prog.axis(a).size))
            elif a in foldable:
                tile_sz[a] = self.prog.axis(a).size
            else:
                tile_sz[a] = 1

        # Cartesian tiling of the window domain.
        axes = window_axes
        counts = [math.ceil(self.prog.axis(a).size / tile_sz[a]) for a in axes]
        tiles: list[ComputeTile] = []
        total = 1
        for c in counts:
            total *= c
        for flat in range(total):
            rem, offs, szs = flat, {}, {}
            for a, c in zip(axes, counts):
                pos = rem % c
                rem //= c
                offs[a] = pos * tile_sz[a]
                szs[a] = min(tile_sz[a], self.prog.axis(a).size - offs[a])
            tiles.append(ComputeTile(
                instr_idx=idx, needle_name=si.needle.name,
                offsets=offs, sizes=szs,
                operands=self._tile_operands(si, offs, szs)))
        return tiles

    def _foldable_outer(self, si: SelectedInstr, window_axes,
                        mapped_h) -> set[str]:
        """Outer axes that every window access indexes through a dedicated
        coeff-1 dimension — safe to coalesce for elementwise instructions."""
        from .instructions import is_elementwise
        if not is_elementwise(si.needle.name):
            return set()
        folds = set()
        for a in window_axes:
            if a in mapped_h:
                continue
            ai = self.prog.axis_index(a)
            ok = True
            for hi in si.mapping.stmt_map:
                st = self.prog.statements[hi]
                for acc in (st.lhs, st.rhs):
                    rows = [i for i, row in enumerate(acc.matrix) if row[ai]]
                    if len(rows) != 1:
                        ok = False
                        break
                    row = acc.matrix[rows[0]]
                    if row[ai] != 1 or any(c for j, c in enumerate(row)
                                           if j != ai):
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                folds.add(a)
        return folds

    def _tile_operands(self, si: SelectedInstr, offs: dict[str, int],
                       szs: dict[str, int]) -> list:
        """Regions of each materialized needle operand for one tile."""
        m = si.mapping
        bm = dict(m.buffer_map)
        operands = []
        reads: set[str] = set()
        writes: set[str] = set()
        for ns in si.needle.statements:
            if ns.op in (":=", "apply"):
                reads.add(ns.rhs.buffer)
            else:
                reads.add(ns.rhs.buffer)
                reads.add(ns.lhs.buffer)
            writes.add(ns.lhs.buffer)
        for nb in si.needle.buffers:
            if nb.temp or nb.name not in bm:
                continue
            hb = bm[nb.name]
            region = self._operand_region(si, nb.name, hb, offs, szs)
            operands.append((nb.name, region,
                             nb.name in reads, nb.name in writes))
        return operands

    def _operand_region(self, si: SelectedInstr, nb: str, hb: str,
                        offs: dict[str, int], szs: dict[str, int]) -> Region:
        # find a representative haystack access of hb inside the window
        acc = None
        for hi in si.mapping.stmt_map:
            s = self.prog.statements[hi]
            for cand in (s.lhs, s.rhs):
                if cand.buffer == hb:
                    acc = cand
                    break
            if acc:
                break
        assert acc is not None, (nb, hb)
        names = self.prog.axis_names
        bounds = []
        for row, const in zip(acc.matrix, acc.offset):
            start, span = const, 1
            for ai, coeff in enumerate(row):
                if coeff == 0:
                    continue
                a = names[ai]
                o = offs.get(a, 0)
                s_ = szs.get(a, self.prog.axis(a).size if a in offs else 1)
                if a not in offs:      # axis outside this window: full extent
                    o, s_ = 0, self.prog.axis(a).size
                if coeff > 0:
                    start += coeff * o
                    span += coeff * (s_ - 1)
                else:
                    start += coeff * (o + s_ - 1)
                    span += -coeff * (s_ - 1)
            bounds.append((start, span))
        return Region(hb, tuple(bounds))

    # -- memory movement (Section 3.5) ------------------------------------------
    def _reconcile(self, region: Region):
        """Flush intersecting dirty regions of other granularities back to the
        buffer's home so it is authoritative for this region's bytes."""
        others = self.state.overlapping_dirty(region)
        if not others:
            return
        home = self.homes[region.buffer]
        flush = others + self.state.overlapping_dirty(region, include_exact=True)
        seen = set()
        for k2 in flush:
            if k2 in seen:
                continue
            seen.add(k2)
            r2 = Region(*k2)
            v2 = self.state.version.get(k2, 0)
            src = next((n for n, v in self.state.copies.get(k2, {}).items()
                        if v == v2), None)
            if src is None or src == home:
                continue
            for e in self.graph.shortest_path(src, home,
                                              self.state.nbytes(r2)):
                self._emit(kind="writeback", device=e.issuer, src=e.src,
                           dst=e.dst, region=r2)
            self.state.install(home, r2, dirty=False)
            # ensure home registers the *latest* version, not version 0
            self.state.copies[k2][home] = v2

    def _invalidate_overlaps(self, region: Region):
        """After a write, stale copies of intersecting region keys may only
        survive at home (which _reconcile keeps authoritative)."""
        k = self.state.key(region)
        home = self.homes[region.buffer]
        for k2 in list(self.state.copies):
            if k2 == k or k2[0] != region.buffer:
                continue
            if not _bounds_overlap(k2[1], region.bounds):
                continue
            for node in list(self.state.copies[k2]):
                if node != home:
                    self.state.drop(node, k2)

    def _route_region(self, region: Region, dst: str, device: str,
                      pinned: frozenset = frozenset()):
        """Ensure the latest version of ``region`` resides in memory ``dst``,
        emitting COPY ops along an Approach-chosen path.  Intermediate copies
        are installed too — they act as caches for later reuse."""
        self._reconcile(region)
        holders = self.state.holders(region)
        if dst in holders:
            self.state.touch(dst, region)
            return
        nbytes = self.state.nbytes(region)
        options = []
        for node in holders:
            try:
                path = self.approach.choose_path(self.graph, node, dst, nbytes)
            except KeyError:
                continue
            cost = sum(e.latency + nbytes / e.bandwidth for e in path)
            options.append((node, cost, path))
        if not options:
            raise ScheduleError(f"no path to move {region} to {dst}")
        src = self.approach.choose_source([(n, c) for n, c, _ in options])
        path = next(p for n, _, p in options if n == src)
        for e in path:
            self._make_room(e.dst, nbytes,
                            pinned | {self.state.key(region)})
            self._emit(kind="copy", device=e.issuer, src=e.src, dst=e.dst,
                       region=region)
            self.state.install(e.dst, region, dirty=False)

    def _make_room(self, node: str, nbytes: int, pinned: frozenset | set):
        cap = self.graph.memories[node].capacity
        if self.state.used.get(node, 0) + nbytes <= cap:
            return
        # LRU eviction; dirty copies are written back to their home first.
        lru_items = sorted(
            ((n, k) for (n, k) in self.state.lru if n == node and k not in pinned),
            key=lambda nk: self.state.lru[nk])
        for n, k in lru_items:
            if self.state.used[node] + nbytes <= cap:
                return
            buf, bnds = k
            region = Region(buf, bnds)
            ver = self.state.copies.get(k, {}).get(node)
            latest = self.state.version.get(k, 0)
            home = self.homes[buf]
            if ver == latest and latest > 0 and node != home \
                    and self.state.copies.get(k, {}).get(home) != latest:
                # dirty sole-latest copy: write back along the path home
                for e in self.graph.shortest_path(node, home,
                                                  self.state.nbytes(region)):
                    self._emit(kind="writeback", device=e.issuer, src=e.src,
                               dst=e.dst, region=region)
                self.state.install(home, region, dirty=False)
                self.state.copies[k][home] = latest
            self.state.drop(node, k)
        if self.state.used[node] + nbytes > cap:
            raise ScheduleError(
                f"memory node {node} cannot fit {nbytes} bytes "
                f"(capacity {cap}, used {self.state.used[node]})")

    # -- main entry -----------------------------------------------------------
    def run(self) -> Schedule:
        return self.run_body(writeback=True)

    def run_body(self, writeback: bool = True, first_instr: int = 0,
                 record_segments: bool = False) -> Schedule:
        """Schedule instructions ``first_instr..`` on top of the current
        state/ops (both empty for a fresh run; pre-seeded with a parent's
        prefix for an incremental resume).  Skipping a prefix is sound
        because both unroll policies sort by ``instr_idx`` first, so the
        tile stream of a suffix equals the suffix of the full tile stream.

        With ``record_segments`` the scheduler snapshots ``(op count,
        state)`` after the last tile of every instruction (except the final
        one), keyed by instr idx — the resume points ``schedule_incremental``
        splices from."""
        all_tiles: list[ComputeTile] = []
        for idx, si in enumerate(self.sel.instrs):
            devices = self.graph.compute_nodes_for(si.needle.name)
            if not devices:
                raise ScheduleError(f"no device executes {si.needle.name}")
            hw_tile = devices[0].matmul_tile
            if idx < first_instr:
                continue
            all_tiles.extend(self._tiles_for(idx, si, hw_tile))

        tiles = self.approach.unroll_order(all_tiles)

        prev_idx: int | None = None
        for tile in tiles:
            if record_segments and prev_idx is not None \
                    and tile.instr_idx != prev_idx:
                self.segments[prev_idx] = (len(self.ops), self.state.clone())
            prev_idx = tile.instr_idx
            devices = self.graph.compute_nodes_for(tile.needle_name)
            dev = self.approach.choose_device(tile, devices, self.state)
            tile.device = dev.name
            mem = dev.memory
            pinned = frozenset(self.state.key(region)
                               for _, region, _, _ in tile.operands)
            for nb, region, r, w in tile.operands:
                if r:
                    self._route_region(region, mem, dev.name, pinned)
                else:
                    self._reconcile(region)  # overlapping dirty data -> home
                    self._make_room(mem, self.state.nbytes(region), pinned)
                    self.state.install(mem, region, dirty=False)
            self._emit(kind="compute", device=dev.name, tile=tile)
            self.state.device_load[dev.name] = (
                self.state.device_load.get(dev.name, 0.0)
                + self._compute_time(dev, tile))
            for nb, region, r, w in tile.operands:
                if w:
                    self.state.install(mem, region, dirty=True)  # invalidates
                    self._invalidate_overlaps(region)

        if writeback:
            self._writeback_outputs()
        sched = Schedule(self.prog, self.graph, self.ops,
                         final_residency={k: dict(v) for k, v in
                                          self.state.copies.items()},
                         homes=dict(self.homes))
        cost_model(sched)
        return sched

    def _writeback_outputs(self):
        """Move final output regions back to their home memories."""
        for k, holders in list(self.state.copies.items()):
            buf, bnds = k
            if buf not in self.prog.outputs:
                continue
            region = Region(buf, bnds)
            latest = self.state.version.get(k, 0)
            home = self.homes[buf]
            if latest == 0:
                continue
            if self.state.copies.get(k, {}).get(home) == latest:
                continue
            src = next(n for n, v in holders.items() if v == latest)
            for e in self.graph.shortest_path(src, home,
                                              self.state.nbytes(region)):
                self._emit(kind="writeback", device=e.issuer, src=e.src,
                           dst=e.dst, region=region)
            self.state.install(home, region, dirty=False)

    # -- cost model -------------------------------------------------------------
    def _compute_time(self, dev: ComputeNode, tile: ComputeTile) -> float:
        return compute_time(dev, tile)


def compute_time(dev: ComputeNode, tile: ComputeTile) -> float:
    """Modeled execution time of one tile on one device.

    Matmul tiles are charged in whole MXU passes (a 1x128x128 call costs a
    full 128^3 pass) — this is what makes library-unfriendly skinny GEMMs
    expensive and reproduces the paper's Figure 3(d) effect.
    """
    name = tile.needle_name
    if name.startswith(("mxu.matmul", "fused.matmul")):
        ti, tj, tk = dev.matmul_tile
        out = tile.output_region()
        vol = 1
        for s in tile.sizes.values():
            vol *= s
        out_vol = 1
        for s in (out.shape if out else ()):
            out_vol *= s
        k_vol = max(1, vol // max(out_vol, 1))
        passes = (math.ceil(out_vol / (ti * tj)) * math.ceil(k_vol / tk))
        t = passes * (ti * tj * tk * 2) / dev.flops_per_sec
        if name.startswith("fused."):
            t += out_vol / (dev.vector_lanes * dev.clock_hz) * 2
        return t
    # VPU-style ops: elements / lanes
    vol = 1
    for s in tile.sizes.values():
        vol *= s
    return vol / (dev.vector_lanes * dev.clock_hz)


def cost_model(sched: Schedule) -> float:
    """Replay the op stream on per-resource timelines.  DMA engines (one per
    edge) run asynchronously from compute nodes, so copies for tile t+1
    overlap with tile t's compute when dependencies allow."""
    g = sched.graph
    resource_free: dict[str, float] = {}
    region_avail: dict[tuple[tuple, str], float] = {}  # (region key, node) -> t

    def avail(region: Region, node: str) -> float:
        return region_avail.get(((region.buffer, region.bounds), node), 0.0)

    for op in sched.ops:
        if op.kind in ("copy", "writeback"):
            e = g.edge(op.src, op.dst)
            res = f"dma:{op.src}->{op.dst}"
            ready = avail(op.region, op.src)
            start = max(resource_free.get(res, 0.0), ready)
            dur = e.latency + sched.region_nbytes(op.region) / e.bandwidth
            end = start + dur
            resource_free[res] = end
            key = ((op.region.buffer, op.region.bounds), op.dst)
            region_avail[key] = end
        else:
            dev = g.computes[op.device]
            mem = dev.memory
            ready = 0.0
            for _, region, r, _ in op.tile.operands:
                if r:
                    ready = max(ready, avail(region, mem))
            start = max(resource_free.get(op.device, 0.0), ready)
            end = start + compute_time(dev, op.tile)
            resource_free[op.device] = end
            for _, region, _, w in op.tile.operands:
                if w:
                    region_avail[((region.buffer, region.bounds), mem)] = end
        op.start, op.end = start, end

    sched.makespan = max((op.end for op in sched.ops), default=0.0)
    sched.device_busy = {
        d: sum(op.end - op.start for op in sched.ops
               if op.kind == "compute" and op.device == d)
        for d in g.computes}
    return sched.makespan


def schedule(selection: Selection, graph: SystemGraph,
             approach: Approach | None = None,
             state: SchedulerState | None = None) -> Schedule:
    """Convenience entry point."""
    from .approach import CostModelApproach
    if isinstance(approach, CostModelApproach):
        best = None
        for cand in approach.candidates():
            s = Scheduler(selection, graph, cand,
                          state=None if state is None else _clone_state(state)).run()
            if best is None or s.makespan < best.makespan:
                best = s
        return best
    return Scheduler(selection, graph, approach, state=state).run()


def _clone_state(state: SchedulerState) -> SchedulerState:
    return copy.deepcopy(state)


# --------------------------------------------------------------------------- #
# Incremental re-scheduling (local-walk neighbors)
# --------------------------------------------------------------------------- #


def schedule_with_segments(
        selection: Selection, graph: SystemGraph,
        approach: Approach) -> tuple[Schedule, dict]:
    """Full schedule plus per-instruction resume points.  The returned
    ``segments`` map (instr idx -> (op count, state snapshot)) is the anchor
    a later :func:`schedule_incremental` call resumes from."""
    sch = Scheduler(selection, graph, approach)
    sched = sch.run_body(writeback=True, record_segments=True)
    return sched, sch.segments


def schedule_incremental(
        selection: Selection, graph: SystemGraph, approach: Approach,
        parent_sched: Schedule, segments: dict,
        first_changed: int, record: bool = False) -> tuple[Schedule, dict]:
    """Re-schedule reusing the parent's op stream for every instruction
    before ``first_changed`` (the first SelectedInstr whose resolved tile
    differs from the parent's).  Sound because tile streams are instr-major
    (suffix-sort equality), the snapshot carries the full versioned-copy
    state plus the round_robin cursor, and the cost model's replay is
    prefix-causal — so the spliced prefix replays to identical times and the
    suffix is scheduled exactly as a from-scratch run would schedule it.

    Falls back to a from-scratch :func:`schedule_with_segments` when no
    snapshot precedes ``first_changed`` (e.g. the first instruction
    changed)."""
    if first_changed <= 0 or (first_changed - 1) not in segments:
        return schedule_with_segments(selection, graph, approach)
    boundary, snap = segments[first_changed - 1]
    sch = Scheduler(selection, graph, approach, state=snap.clone())
    # Prefix ops are shallow-copied: cost_model mutates op.start/end, and the
    # parent schedule must keep its own timings.
    sch.ops = [copy.copy(op) for op in parent_sched.ops[:boundary]]
    sch._uid = boundary
    sched = sch.run_body(writeback=True, first_instr=first_changed,
                         record_segments=record)
    # The parent's prefix snapshots remain valid resume points for the
    # child (the spliced prefix is identical by construction).
    for idx, ent in segments.items():
        if idx < first_changed:
            sch.segments.setdefault(idx, ent)
    return sched, sch.segments
