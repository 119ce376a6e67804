"""The Approach class — unified interface to all compiler choices (Section 4).

Every combinatorial decision the compiler makes is routed through one of the
methods below: instruction ranking, tiling factors, unroll order, device
allocation, copy-source selection, memory paths, and buffer homes.  The
default ``GreedyApproach`` implements the paper's heuristics; CostModel- and
random-sampling Approaches plug in without touching compiler internals.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Sequence

if TYPE_CHECKING:  # pragma: no cover
    from .isel import SelectedInstr
    from .scheduler import ComputeTile, SchedulerState
    from .sysgraph import ComputeNode, MoveEdge, SystemGraph


#: Unroll-order sort keys.  Both keep reduction offsets ascending within a
#: fixed output region, so tiled accumulation replays the oracle's summation
#: order exactly (the executor-vs-interpret bit-exactness the search
#: subsystem validates against).
UNROLL_POLICIES = {
    # outputs adjacent, reduction innermost (the paper's 3.3 heuristic)
    "out_major": lambda t: (t.instr_idx, t.out_key(), t.red_key()),
    # sweep the reduction front across outputs (panel-major issue order)
    "red_major": lambda t: (t.instr_idx, t.red_key(), t.out_key()),
}

#: Allocation policies for choose_device.
DEVICE_POLICIES = ("locality", "load", "round_robin")

#: Copy-source policies for choose_source.
SOURCE_POLICIES = ("cheapest", "first")


class Approach:
    """Base class: every method has the paper's default heuristic.

    Every *decision point* is also exposed as plain data (the class
    attributes below), so search-based Approaches (``repro.search``) can
    drive the full mapping/schedule space from an explicit config vector
    without overriding methods.  The defaults reproduce ``GreedyApproach``
    exactly.
    """

    # ---- decision points as data (driven by repro.search.space) -----------
    #: ceiling on the staging-memory bytes a tile working set may claim.
    #: The effective budget is min(this, the target graph's
    #: ``staging_budget``) — on real targets the graph-derived budget (TPU
    #: VMEM, GPU shared memory, register files) is the binding term and
    #: this constant only caps budget-free calls.
    tile_vmem_budget: int = 96 << 20
    #: fraction of the (device-capped) budget the tile may actually use
    vmem_frac: float = 1.0
    #: explicit (i, j, k) tile caps; ``None`` entries fall back to the
    #: hardware tile (i, j) / budget-deep streaming (k)
    tile_caps: tuple[int | None, int | None, int | None] = (None, None, None)
    #: stream the reduction axis as deep as the VMEM budget allows
    stream_k: bool = True
    #: grow the j tile into leftover budget (fewer output routings)
    grow_j: bool = True
    #: key into UNROLL_POLICIES
    unroll_policy: str = "out_major"
    #: one of DEVICE_POLICIES
    device_policy: str = "locality"
    #: one of SOURCE_POLICIES
    source_policy: str = "cheapest"

    # ---- instruction selection (Section 2.4) ------------------------------
    def rank_instruction(self, si: "SelectedInstr", prog):
        """Sort key: minimum final instruction count — widest window first,
        then fewest invocations."""
        return (-len(si.mapping.stmt_map), si.mapping.calls(prog))

    # ---- tiling (Section 3.3) ---------------------------------------------
    def choose_tile_shape(self, needle_name: str, extents: dict[str, int],
                          hw_tile: tuple[int, int, int],
                          vmem_budget: int | None = None) -> dict[str, int]:
        """Tile sizes for the mapped (i, j, k) axes of a matmul-like needle.

        By default output dims (i, j) tile at the hardware shape and the
        reduction axis streams as deep as the VMEM budget allows (copy
        coalescing: one big panel DMA replaces ceil(K/tk) small ones, and
        the MXU pipelines the k-passes within the tile).  ``tile_caps`` /
        ``stream_k`` / ``grow_j`` / ``vmem_frac`` override each piece."""
        ti, tj, tk = hw_tile
        cap_i = self.tile_caps[0] or ti
        cap_j = self.tile_caps[1] or tj
        cap_k = self.tile_caps[2]
        out = {}
        for axis, ext in extents.items():
            cap = {"i": cap_i, "j": cap_j}.get(axis)
            if cap is not None:
                out[axis] = min(ext, cap)
        budget = self.tile_vmem_budget
        if vmem_budget is not None:
            budget = min(budget, vmem_budget)
        budget = int(budget * self.vmem_frac)
        if "k" in extents:
            bm = out.get("i", cap_i)
            bn = out.get("j", cap_j)
            if cap_k is not None:
                out["k"] = min(extents["k"], max(tk, cap_k))
            elif self.stream_k:
                # A panel (bm, k) + B panel (k, bn) + C tile, 4B each
                k_max = max(tk, (budget // 4 - bm * bn) // max(bm + bn, 1))
                out["k"] = min(extents["k"], k_max)
            else:
                out["k"] = min(extents["k"], tk)
            # grow the j tile into leftover budget (fewer output routings),
            # MXU-aligned
            bk = out["k"]
            if self.grow_j and "j" in extents:
                j_max = (budget // 4 - bm * bk) // max(bk + bm, 1)
                j_max = max(tj, (j_max // tj) * tj)
                out["j"] = min(extents["j"], max(out.get("j", tj), j_max))
        for axis, ext in extents.items():
            out.setdefault(axis, min(ext, max(ti, tj, tk)))
        return out

    # ---- unrolling (Section 3.3) ------------------------------------------
    def unroll_order(self, tiles: list["ComputeTile"]) -> list["ComputeTile"]:
        """Dependency/issue order, selected by ``unroll_policy``.  Default
        (paper 3.3): place computations which use the same memory close
        together — sort by output region so accumulation chains are
        adjacent, keeping the reduction (k) innermost."""
        return sorted(tiles, key=UNROLL_POLICIES[self.unroll_policy])

    # ---- device allocation (Section 3.4) ------------------------------------
    def choose_device(self, tile: "ComputeTile",
                      candidates: Sequence["ComputeNode"],
                      state: "SchedulerState") -> "ComputeNode":
        """Balance memory locality against parallelism (paper 3.4).  The
        default ``locality`` policy prefers the device whose memory already
        holds the most operand bytes (so persistent weights pin work to
        their core), then least-loaded; ``load`` inverts the priority;
        ``round_robin`` spreads tiles blindly."""
        if self.device_policy == "round_robin":
            # the cursor lives on the per-run scheduler state, so a reused
            # Approach instance stays deterministic across schedule() calls
            order = sorted(candidates, key=lambda c: c.name)
            rr = getattr(state, "_rr_cursor", 0)
            state._rr_cursor = rr + 1
            return order[rr % len(order)]
        best, best_key = None, None
        for c in candidates:
            missing = 0
            for _, region, r, w in tile.operands:
                resident = state.holds_region(c.memory, region)
                if (r or w) and not resident:
                    missing += state.nbytes(region)
            load = state.device_load.get(c.name, 0.0)
            key = ((load, missing) if self.device_policy == "load"
                   else (missing, load))
            if best_key is None or key < best_key:
                best, best_key = c, key
        return best

    # ---- memory movement (Section 3.5) ---------------------------------------
    def choose_source(self, options: list[tuple[str, float]]) -> str:
        """Pick which existing copy to read from: (memory node, est. cost)."""
        if self.source_policy == "first":
            return options[0][0]
        return min(options, key=lambda o: o[1])[0]

    def choose_path(self, graph: "SystemGraph", src: str, dst: str,
                    nbytes: int) -> list["MoveEdge"]:
        return graph.shortest_path(src, dst, nbytes)

    def choose_home(self, buffer_name: str, nbytes: int,
                    graph: "SystemGraph") -> str:
        """Initial residence of a buffer: round-robin across the level-1
        (HBM) modules, falling back to host for oversized buffers."""
        hbms = sorted(m.name for m in graph.memories.values() if m.level == 1)
        if not hbms:
            return "host"
        pick = hbms[hash(buffer_name) % len(hbms)]
        if nbytes > graph.memories[pick].capacity // 2:
            return "host"
        return pick


class GreedyApproach(Approach):
    """The paper's reported configuration: pure heuristics."""


@dataclass
class RandomApproach(Approach):
    """Random choices — the sampling primitive for search-based approaches."""

    seed: int = 0
    rng: random.Random = field(init=False)

    def __post_init__(self):
        self.rng = random.Random(self.seed)

    def choose_device(self, tile, candidates, state):
        return self.rng.choice(list(candidates))

    def unroll_order(self, tiles):
        tiles = list(tiles)
        self.rng.shuffle(tiles)
        # keep accumulation chains valid: stable-sort back by output region
        tiles.sort(key=lambda t: (t.instr_idx, t.out_key()))
        return tiles


class CostModelApproach(Approach):
    """Samples N candidate Approaches, schedules with each, and keeps the one
    whose *modeled makespan* (scheduler cost model) is lowest.  This is the
    'cost models and potentially machine learning' extension point of
    Section 4 — implemented as schedule-level search."""

    def __init__(self, samples: int = 8, seed: int = 0):
        self.samples = samples
        self.seed = seed

    def candidates(self) -> list[Approach]:
        return [GreedyApproach()] + [RandomApproach(self.seed + s)
                                     for s in range(self.samples - 1)]
