"""Schedule executor — "replay" execution of the recorded instruction stream.

The static scheduler emits COPY / COMPUTE / WRITEBACK ops; this module
replays them with real data, byte-for-byte honouring the memory system the
schedule claims (region copies live per memory node; computes only touch
operands resident in their compute node's memory).  Any scheduling bug —
wrong invalidation, missing copy, bad region math — surfaces as a numeric
mismatch against the pure ISAMIR oracle (ir.interpret).

Needle semantics are executed by *interpreting the needle program itself* on
the tile's operand views, so the executor contains no per-instruction code.
"""
from __future__ import annotations

import numpy as np

from .ir import Axis, Buffer, Program, interpret
from .isel import SelectedInstr, Selection
from .scheduler import Region, Schedule, ScheduledOp


class ExecutionError(RuntimeError):
    pass


class Machine:
    """Materialized memory state: every memory node holds exact region copies
    (the home node holds whole buffers)."""

    def __init__(self, schedule: Schedule, inputs: dict[str, np.ndarray]):
        self.sched = schedule
        self.prog = schedule.program
        # home storage: full arrays
        self.home_data: dict[str, np.ndarray] = {}
        for b in self.prog.buffers:
            if b.name not in schedule.homes:
                continue
            if b.name in inputs:
                arr = np.asarray(inputs[b.name], dtype=np.float64)
                if arr.shape != b.shape:
                    raise ExecutionError(
                        f"input {b.name}: shape {arr.shape} != {b.shape}")
                self.home_data[b.name] = arr.copy()
            else:
                self.home_data[b.name] = np.zeros(b.shape, dtype=np.float64)
        # region copies: (memory node, buffer, bounds) -> array
        self.region_data: dict[tuple, np.ndarray] = {}

    # -- data access -----------------------------------------------------------
    def _slices(self, region: Region) -> tuple[slice, ...]:
        return tuple(slice(s, s + n) for s, n in region.bounds)

    def read(self, node: str, region: Region) -> np.ndarray:
        key = (node, region.buffer, region.bounds)
        if key in self.region_data:
            return self.region_data[key]
        if node == self.sched.homes.get(region.buffer):
            return self.home_data[region.buffer][self._slices(region)]
        raise ExecutionError(f"{region} not resident in {node}")

    def write(self, node: str, region: Region, value: np.ndarray):
        if node == self.sched.homes.get(region.buffer):
            self.home_data[region.buffer][self._slices(region)] = value
        else:
            self.region_data[(node, region.buffer, region.bounds)] = \
                np.array(value, dtype=np.float64)

    # -- op execution -----------------------------------------------------------
    def run_op(self, op: ScheduledOp, selection: Selection):
        if op.kind in ("copy", "writeback"):
            self.write(op.dst, op.region, self.read(op.src, op.region))
        elif op.kind == "compute":
            self._run_compute(op, selection)
        else:  # pragma: no cover
            raise ExecutionError(f"unknown op kind {op.kind}")

    def _run_compute(self, op: ScheduledOp, selection: Selection):
        tile = op.tile
        si = selection.instrs[tile.instr_idx]
        mem = self.sched.graph.computes[op.device].memory
        needle = _sized_needle(si, tile)

        ins: dict[str, np.ndarray] = {}
        out_specs: list[tuple[str, Region, np.ndarray]] = []
        for nb_name, region, r, w in tile.operands:
            if r:
                arr = np.asarray(self.read(mem, region), dtype=np.float64)
            else:  # write-only operand: fresh storage, never read
                arr = np.zeros(region.shape, dtype=np.float64)
            view = _operand_view(arr, si, nb_name, needle)
            ins[nb_name] = view
            if w:
                out_specs.append((nb_name, region, arr))

        # The machine state is f64 end-to-end; rounding tile outputs to the
        # buffer dtype here would make multi-tile accumulation chains (and
        # chip-chained fabric reductions) diverge from the oracle's
        # single-final-cast contract.
        outs = interpret(needle, ins, cast_outputs=False)
        for nb_name, region, arr in out_specs:
            res = outs[nb_name]
            inv = _operand_view_inverse(arr.shape, si, nb_name, res)
            self.write(mem, region, inv)


def _sized_needle(si: SelectedInstr, tile) -> Program:
    """Clone the needle with concrete axis extents (= tile sizes) and buffer
    shapes derived from its accesses.  Elementwise needles whose outer axes
    were coalesced get a single flattened axis of the full tile volume."""
    from .instructions import is_elementwise
    axis_map = dict(si.mapping.axis_map)
    if is_elementwise(si.needle.name):
        vol = 1
        for v in tile.sizes.values():
            vol *= v
        sizes = {na: vol for na in axis_map}
    else:
        sizes = {na: tile.sizes.get(ha, 1) for na, ha in axis_map.items()}
    axes = tuple(Axis(a.name, sizes.get(a.name, a.size or 1))
                 for a in si.needle.axes)
    ext = {a.name: a.size for a in axes}

    def buf_shape(b: Buffer) -> tuple[int, ...]:
        # extent of each dim from any access of this buffer
        shape = list(b.shape)
        for s in si.needle.statements:
            for acc in (s.lhs, s.rhs):
                if acc.buffer != b.name:
                    continue
                for d, (row, off) in enumerate(zip(acc.matrix, acc.offset)):
                    span = 1 + off
                    for ai, coeff in enumerate(row):
                        if coeff:
                            span += abs(coeff) * (ext[si.needle.axes[ai].name] - 1)
                    shape[d] = max(shape[d] or 0, span)
        return tuple(max(1, s) for s in shape)

    buffers = tuple(Buffer(b.name, buf_shape(b), b.dtype, b.temp)
                    for b in si.needle.buffers)
    return Program(si.needle.name, axes, buffers, si.needle.statements,
                   si.needle.outputs)


def _operand_view(arr: np.ndarray, si: SelectedInstr, nb_name: str,
                  needle: Program) -> np.ndarray:
    """Reorder a haystack region array into the needle operand's dim order:
    needle dim d corresponds to haystack dim D = dim_map[d]; remaining
    haystack dims must be singleton (outer-axis offsets) and are dropped.
    Coalesced elementwise tiles flatten the whole region."""
    from .instructions import is_elementwise
    if is_elementwise(si.needle.name):
        return np.ascontiguousarray(arr).reshape(-1)
    dm = dict(si.mapping.dim_map)[nb_name]
    nb = needle.buffer(nb_name)
    # choose, for each needle dim, the haystack dim index
    take = list(dm)
    rest = [d for d in range(arr.ndim) if d not in take]
    for d in rest:
        if arr.shape[d] != 1:
            raise ExecutionError(
                f"unmapped haystack dim {d} of {nb_name} region has extent "
                f"{arr.shape[d]} (expected 1)")
    perm = take + rest
    view = np.transpose(arr, perm)
    view = view.reshape(view.shape[:len(take)])
    # pad/crop to needle shape (boundary tiles are smaller than the block)
    target = nb.shape
    if view.shape != tuple(target):
        pad = [(0, t - s) for s, t in zip(view.shape, target)]
        if any(p[1] < 0 for p in pad):
            raise ExecutionError(
                f"operand {nb_name} region {view.shape} exceeds needle shape "
                f"{target}")
        view = np.pad(view, pad)
    return view


def _operand_view_inverse(region_shape: tuple[int, ...], si: SelectedInstr,
                          nb_name: str, result: np.ndarray) -> np.ndarray:
    """Inverse of _operand_view for written operands."""
    from .instructions import is_elementwise
    if is_elementwise(si.needle.name):
        return result.reshape(region_shape)
    dm = dict(si.mapping.dim_map)[nb_name]
    take = list(dm)
    rest = [d for d in range(len(region_shape)) if d not in take]
    # crop padding back off
    crop = tuple(slice(0, region_shape[d]) for d in take)
    res = result[crop]
    res = res.reshape(res.shape + (1,) * len(rest))
    # res dims currently: needle-dim order then singleton rest; invert perm
    perm = take + rest
    inv = np.argsort(perm)
    return np.transpose(res, inv)


def execute(schedule: Schedule, selection: Selection,
            inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Run the schedule; return the program outputs read from their homes."""
    m = Machine(schedule, inputs)
    for op in schedule.ops:
        m.run_op(op, selection)
    out = {}
    for name in schedule.program.outputs:
        out[name] = m.home_data[name].astype(np.float32)
    return out
