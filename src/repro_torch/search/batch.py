"""Vectorized population evaluation (the throughput tier of repro_torch.search).

Scalar tuning pays two per-config costs: the tile-count feasibility guard
(``CostModelEvaluator.estimated_tiles`` — a Python loop over instructions)
and the schedule itself.  ``BatchPlan`` amortizes the first and exposes the
structure that lets the evaluator skip the second:

  * **Vectorized guard** — ``choose_tile_shape`` + the tile-count bound are
    replayed as numpy array arithmetic over a whole config population at
    once.  The arithmetic mirrors ``Approach.choose_tile_shape`` exactly
    (including truncation and floor-division behavior), so batch
    feasibility is bit-identical to the scalar guard.

  * **Schedule keys** — a config influences the scheduler only through
    (a) each instruction's resolved mapped-axis tile sizes (clamped to the
    extents, as ``Scheduler._tiles_for`` clamps them), (b) the unroll
    policy, and (c) the device/source policies *where they can matter*.
    On a single-core graph every device policy picks the same device and
    every source policy sees at most one candidate copy, so those axes are
    dropped from the key — configs that alias to the same key provably
    produce the same schedule, and the evaluator scores them once.

The plan is deliberately selection-static: everything that does not depend
on the config (extents, hardware tiles, VMEM budgets, call counts, policy
droppability) is computed once in ``__init__``.
"""
from __future__ import annotations

import numpy as np

from ..core.approach import GreedyApproach
from ..core.instructions import is_elementwise
from ..core.isel import Selection
from ..core.scheduler import Scheduler
from ..core.sysgraph import SystemGraph
from .space import ParamApproach

#: schedule key: (per-instr clamped tile tuples, unroll, device, source)
ScheduleKey = tuple


class _InstrPlan:
    """Config-independent data of one SelectedInstr (guard + key inputs)."""

    __slots__ = ("axes", "extents", "hw_tile", "vmem_budget", "calls",
                 "has_k", "ext_i", "ext_j", "ext_k")

    def __init__(self, si, prog, graph: SystemGraph):
        devices = graph.compute_nodes_for(si.needle.name)
        # axis_map order is the deterministic per-instr axis order everywhere
        self.axes = [na for na, _ in si.mapping.axis_map]
        self.extents = {na: prog.axis(ha).size for na, ha in si.mapping.axis_map}
        self.hw_tile = devices[0].matmul_tile
        self.vmem_budget = graph.staging_budget(devices)
        self.calls = 1 if is_elementwise(si.needle.name) \
            else si.mapping.calls(prog)
        self.has_k = "k" in self.extents
        self.ext_i = self.extents.get("i")
        self.ext_j = self.extents.get("j")
        self.ext_k = self.extents.get("k")


class BatchPlan:
    """Population-level feasibility + schedule-key analysis for one
    (selection, graph) pair."""

    def __init__(self, selection: Selection, graph: SystemGraph):
        self.sel = selection
        self.graph = graph
        prog = selection.program
        self.instrs = [_InstrPlan(si, prog, graph) for si in selection.instrs
                       if graph.compute_nodes_for(si.needle.name)]
        #: some instruction has no executing device: every compile fails,
        #: so every config scores inf without scheduling anything
        self.unschedulable = len(self.instrs) != len(selection.instrs)
        self.device_droppable, self.source_droppable = \
            self._droppable_policies(selection, graph)

    @staticmethod
    def _droppable_policies(selection: Selection,
                            graph: SystemGraph) -> tuple[bool, bool]:
        """Which policy axes provably cannot change the schedule.

        * device: with at most one candidate device per instruction, every
          ``choose_device`` call returns the same node under any policy.
        * source: with a single level-1 HBM that is every buffer's home and
          a single compute memory, the holder set of any routed region is a
          subset of {home, destination vmem}; ``choose_source`` then never
          sees two options, and the reconcile/writeback/evict paths do not
          consult the policy at all.
        """
        try:
            dev_drop = all(
                len(graph.compute_nodes_for(si.needle.name)) <= 1
                for si in selection.instrs)
            hbms = [m.name for m in graph.memories.values() if m.level == 1]
            homes = Scheduler(selection, graph, GreedyApproach()).homes
            compute_mems = {d.memory for si in selection.instrs
                            for d in graph.compute_nodes_for(si.needle.name)}
            src_drop = (len(hbms) == 1
                        and all(h == hbms[0] for h in homes.values())
                        and len(compute_mems) <= 1)
        except Exception:
            return False, False
        return dev_drop, src_drop

    # -- population analysis -------------------------------------------------
    def analyze(self, configs: list[dict],
                max_tiles: int) -> tuple[np.ndarray, list[ScheduleKey]]:
        """(feasible mask, schedule key) per config.

        Feasibility is bit-identical to
        ``CostModelEvaluator.estimated_tiles(...) <= max_tiles``; equal keys
        guarantee equal schedules (and so equal modeled cost).
        """
        n = len(configs)
        if n == 0:
            return np.zeros(0, dtype=bool), []
        # Normalize through ParamApproach so batch parity inherits every
        # scalar fallback rule (falsy caps -> None, bad frac -> 1.0,
        # unknown policy names -> greedy defaults).
        aps = [ParamApproach(c) for c in configs]
        capi = np.array([a.tile_caps[0] or 0 for a in aps], np.int64)
        capj = np.array([a.tile_caps[1] or 0 for a in aps], np.int64)
        capk = np.array([a.tile_caps[2] or 0 for a in aps], np.int64)
        frac = np.array([a.vmem_frac for a in aps], np.float64)
        grow = np.array([a.grow_j for a in aps], bool)
        budget0 = np.array([a.tile_vmem_budget for a in aps], np.int64)

        total = np.zeros(n, np.int64)
        instr_tiles: list[np.ndarray] = []   # one (n, n_axes) array per instr
        for ip in self.instrs:
            out = self._tile_shapes(ip, capi, capj, capk, frac, grow, budget0)
            mapped = np.ones(n, np.int64)
            cols = []
            for axis in ip.axes:
                ext = ip.extents[axis]
                tile = np.maximum(1, np.minimum(out[axis], ext))
                mapped *= -(-ext // tile)            # ceil(ext / tile)
                cols.append(tile)
            total += mapped * ip.calls
            instr_tiles.append(np.stack(cols, axis=1) if cols
                               else np.zeros((n, 0), np.int64))
        feasible = total <= max_tiles

        if self.device_droppable:
            dev = [""] * n
        else:
            dev = [a.device_policy for a in aps]
        if self.source_droppable:
            src = [""] * n
        else:
            src = [a.source_policy for a in aps]
        keys: list[ScheduleKey] = []
        for i in range(n):
            tiles = tuple(tuple(int(x) for x in mat[i])
                          for mat in instr_tiles)
            keys.append((tiles, aps[i].unroll_policy, dev[i], src[i]))
        return feasible, keys

    def first_changed(self, key_a: ScheduleKey, key_b: ScheduleKey) -> int:
        """Index of the first SelectedInstr whose resolved tiles differ
        between two same-policy keys (``len(instrs)`` when none differ)."""
        for idx, (ta, tb) in enumerate(zip(key_a[0], key_b[0])):
            if ta != tb:
                return idx
        return len(key_a[0])

    # -- choose_tile_shape, vectorized ---------------------------------------
    @staticmethod
    def _tile_shapes(ip: _InstrPlan, capi, capj, capk, frac, grow,
                     budget0) -> dict[str, np.ndarray]:
        """``Approach.choose_tile_shape`` over a config population.

        Mirrors the scalar code line by line; numpy int64 floor division
        matches Python ``//`` on negatives, and the budget truncation uses
        the same toward-zero semantics as ``int(...)`` on the (positive)
        scalar product.
        """
        ti, tj, tk = ip.hw_tile
        cap_i = np.where(capi == 0, ti, capi)
        cap_j = np.where(capj == 0, tj, capj)
        out: dict[str, np.ndarray] = {}
        if ip.ext_i is not None:
            out["i"] = np.minimum(ip.ext_i, cap_i)
        if ip.ext_j is not None:
            out["j"] = np.minimum(ip.ext_j, cap_j)
        budget = (np.minimum(budget0, ip.vmem_budget)
                  * frac).astype(np.int64)
        if ip.has_k:
            bm = out.get("i", cap_i)
            bn = out.get("j", cap_j)
            k_capped = np.minimum(ip.ext_k, np.maximum(tk, capk))
            k_max = np.maximum(tk, (budget // 4 - bm * bn)
                               // np.maximum(bm + bn, 1))
            k_stream = np.minimum(ip.ext_k, k_max)
            # ParamApproach: stream_k <=> tile_k cap is None, so the scalar
            # "neither cap nor stream" branch is unreachable here
            out["k"] = np.where(capk > 0, k_capped, k_stream)
            bk = out["k"]
            if ip.ext_j is not None:
                j_max = (budget // 4 - bm * bk) // np.maximum(bk + bm, 1)
                j_max = np.maximum(tj, (j_max // tj) * tj)
                grown = np.minimum(ip.ext_j, np.maximum(out["j"], j_max))
                out["j"] = np.where(grow, grown, out["j"])
        hw_max = max(ti, tj, tk)
        for axis, ext in ip.extents.items():
            if axis not in out:
                out[axis] = np.full(len(capi), min(ext, hw_max), np.int64)
        return out
