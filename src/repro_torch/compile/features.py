"""Engineered feature vectors for the learned cost model
(``repro_torch.search.model``).

One numeric view of a (config, program, system graph) triple, built from the
same quantities the analytical cost model consumes:

  * **config features** — the ParamApproach decision vector: tile caps as
    log2 multiples of the hardware matmul tile (with explicit "uncapped"
    flags, since ``None`` means "let the scheduler grow the tile"), the
    reduction-streaming flag, VMEM fraction, and one-hot unroll/device/source
    policies;
  * **program features** — log-scale FLOPs and footprint bytes, arithmetic
    intensity, statement/axis counts and the largest axis extents (so one
    model generalizes across shapes of a program family);
  * **graph features** — peak compute rate, VMEM/top-level capacities, and
    bandwidth/latency summaries of the movement edges.

Everything is computed from static structure (no scheduling, no torch), so a
prediction costs microseconds while a ``CostModelEvaluator`` call costs a
full schedule.  The feature *names* are part of the model artifact: a stored
model refuses to score vectors whose schema drifted.
"""
from __future__ import annotations

import math
import re

import numpy as np

from ..core.approach import (DEVICE_POLICIES, SOURCE_POLICIES,
                             UNROLL_POLICIES)
from ..core.dtypes import dtype_bytes
from ..core.ir import Program
from ..core.sysgraph import SystemGraph

#: Bumped whenever the feature definition changes — stored models carry it
#: and are ignored (graceful fallback) on mismatch.
FEATURE_SCHEMA = 1

#: How many of the largest axis extents become individual features.
_TOP_AXES = 4

_UNROLLS = tuple(sorted(UNROLL_POLICIES))
_DEVICES = tuple(DEVICE_POLICIES)
_SOURCES = tuple(SOURCE_POLICIES)


def _log10(x: float) -> float:
    return math.log10(max(float(x), 1.0))


def _log2ratio(cap, hw: int) -> float:
    """log2(cap / hw) for a tile cap, 0.0 when uncapped/degenerate."""
    try:
        cap = float(cap)
    except (TypeError, ValueError):
        return 0.0
    if cap <= 0 or hw <= 0:
        return 0.0
    return math.log2(cap / hw)


def program_family(prog: Program | str) -> str:
    """The shape-independent family name of a program: ``matmul_64x64x64``
    -> ``matmul``, ``gru_cell_16x256`` -> ``gru_cell``.  Model artifacts are
    keyed per family so one regression covers a whole suite of shapes."""
    name = prog if isinstance(prog, str) else prog.name
    return re.sub(r"_\d+(x\d+)*$", "", name) or name


def program_features(prog: Program) -> dict[str, float]:
    """Static workload descriptors: log FLOPs (statement work), log bytes
    (non-temp buffer footprint), intensity, and the largest axis extents."""
    flops = 0.0
    for stmt in prog.statements:
        used = set()
        for acc in (stmt.lhs, stmt.rhs):
            used |= acc.axes_used(prog.axis_names)
        work = 1.0
        for a in used:
            work *= max(1, prog.axis(a).size)
        flops += work
    nbytes = 0
    for buf in prog.buffers:
        if buf.temp:
            continue
        n = 1
        for d in buf.shape:
            n *= max(1, d)
        nbytes += n * dtype_bytes(buf.dtype)
    sizes = sorted((prog.axis(a).size for a in prog.axis_names),
                   reverse=True)
    feats = {
        "log_flops": _log10(flops),
        "log_bytes": _log10(nbytes),
        "log_intensity": _log10(flops) - _log10(nbytes),
        "n_stmts": float(len(prog.statements)),
        "n_axes": float(len(prog.axis_names)),
    }
    for i in range(_TOP_AXES):
        feats[f"log_axis_{i}"] = _log10(sizes[i]) if i < len(sizes) else 0.0
    return feats


def graph_features(graph: SystemGraph) -> dict[str, float]:
    """Machine descriptors from the system-graph structure (the same node
    and edge attributes ``sysgraph_fingerprint`` hashes)."""
    flops = [c.flops_per_sec for c in graph.computes.values()]
    caps = [m.capacity for m in graph.memories.values()]
    levels = [m.level for m in graph.memories.values()]
    bws = [e.bandwidth for e in graph.edges]
    lats = [e.latency for e in graph.edges]
    top = [m.capacity for m in graph.memories.values()
           if m.level == max(levels, default=0)]
    return {
        "log_peak_flops": _log10(max(flops, default=1.0)),
        "n_computes": float(len(graph.computes)),
        "log_min_mem": _log10(min(caps, default=1)),
        "log_top_mem": _log10(max(top, default=1)),
        "log_min_bw": _log10(min(bws, default=1.0)),
        "log_max_bw": _log10(max(bws, default=1.0)),
        "log_mean_latency": _log10(1e12 * (sum(lats) / len(lats)
                                           if lats else 0.0)),
        "n_edges": float(len(graph.edges)),
    }


def role_extents(selection) -> dict[str, int]:
    """The (i, j, k) *role* extents of a Selection: for the first
    matmul-mapped instruction, each needle axis's haystack extent.  This is
    what makes tile-cap features meaningful on conv-extraction programs,
    whose haystack axes carry fused names (``y``/``co``/``ci``...) — the
    mapping's ``axis_map`` says which of them the MXU roles land on."""
    prog = selection.program
    for si in selection.instrs:
        if "matmul" not in si.needle.name:
            continue
        return {na: prog.axis(ha).size for na, ha in si.mapping.axis_map}
    return {}


def _default_roles(prog: Program) -> dict[str, int]:
    """Role extents when no Selection is in hand: axes literally named
    i/j/k (the canonical matmul program), else the largest extents in
    descending order — approximate, but deterministic and shape-monotone."""
    names = set(prog.axis_names)
    if {"i", "j", "k"} <= names:
        return {r: prog.axis(r).size for r in ("i", "j", "k")}
    sizes = sorted((prog.axis(a).size for a in prog.axis_names),
                   reverse=True)
    return {r: sizes[x] if x < len(sizes) else 1
            for x, r in enumerate(("i", "j", "k"))}


def config_features(config: dict,
                    hw_tile: tuple[int, int, int] = (128, 128, 128),
                    roles: dict[str, int] | None = None
                    ) -> dict[str, float]:
    """The ParamApproach decision vector, numerically encoded.  Unknown
    policy names degrade exactly as ``ParamApproach`` does (to the greedy
    defaults), so features always describe the schedule actually built.

    The load-bearing terms are the per-role **cap excess** features:
    ``tile_<d>_excess`` = log2 of the extra passes a tile cap forces along
    role ``d`` (0 when the cap doesn't bind or the dim is uncapped), and
    ``tile_<d>_binds`` — whether the cap changes anything at all.  These
    let one linear model learn "capping j on a 64-wide GEMM is free, capping
    i on a 5124-row one costs passes", which raw cap values cannot express.
    """
    from ..search.space import ParamApproach
    pa = ParamApproach(config)
    roles = roles or {}
    feats: dict[str, float] = {}
    for x, d in enumerate(("i", "j", "k")):
        cap = pa.tile_caps[x]
        size = max(1, int(roles.get(d, 0)))
        feats[f"tile_{d}_capped"] = 0.0 if cap is None else 1.0
        feats[f"tile_{d}_log2"] = _log2ratio(cap, hw_tile[x])
        if cap is None or size <= 1:
            excess = 0.0
            binds = 0.0
        else:
            eff = max(1, min(int(cap), size))
            excess = math.log2(math.ceil(size / eff))
            binds = 1.0 if eff < size else 0.0
        feats[f"tile_{d}_excess"] = excess
        feats[f"tile_{d}_binds"] = binds
    feats["stream_k"] = 1.0 if pa.stream_k else 0.0
    feats["vmem_frac"] = float(pa.vmem_frac)
    feats["grow_j"] = 1.0 if pa.grow_j else 0.0
    for name in _UNROLLS:
        feats[f"unroll={name}"] = 1.0 if pa.unroll_policy == name else 0.0
    for name in _DEVICES:
        feats[f"device={name}"] = 1.0 if pa.device_policy == name else 0.0
    for name in _SOURCES:
        feats[f"source={name}"] = 1.0 if pa.source_policy == name else 0.0
    return feats


def _interactions(cfg: dict[str, float], prog: dict[str, float],
                  roles: dict[str, float]) -> dict[str, float]:
    """Second-order terms the linear model needs: a tile cap's cost impact
    scales with the extent of the role it binds against."""
    out = {}
    for dim in ("i", "j", "k"):
        out[f"tile_{dim}_x_role"] = (cfg[f"tile_{dim}_log2"]
                                     * roles[f"log_role_{dim}"])
        out[f"tile_{dim}_binds_x_flops"] = (cfg[f"tile_{dim}_binds"]
                                            * prog["log_flops"])
    out["vmem_x_bytes"] = cfg["vmem_frac"] * prog["log_bytes"]
    out["stream_k_x_flops"] = cfg["stream_k"] * prog["log_flops"]
    return out


def feature_dict(config: dict, prog: Program, graph: SystemGraph,
                 roles: dict[str, int] | None = None) -> dict[str, float]:
    """The full named feature map for one (config, program, graph) triple.
    ``roles`` are the matmul role extents (``role_extents(selection)``);
    derived from axis names/sizes when no selection is available."""
    hw = graph.min_matmul_tile()
    roles = roles or _default_roles(prog)
    cfg = config_features(config, hw, roles)
    pf = program_features(prog)
    gf = graph_features(graph)
    rf = {f"log_role_{d}": _log10(roles.get(d, 1)) for d in ("i", "j", "k")}
    return {**cfg, **pf, **gf, **rf, **_interactions(cfg, pf, rf)}


def feature_names(prog: Program, graph: SystemGraph) -> tuple[str, ...]:
    """Deterministic feature ordering (dict insertion order of
    ``feature_dict``) — stored in the model artifact as its schema."""
    return tuple(feature_dict({}, prog, graph))


def feature_vector(config: dict, prog: Program, graph: SystemGraph,
                   names: tuple[str, ...] | None = None,
                   roles: dict[str, int] | None = None) -> np.ndarray:
    """Feature map flattened to a float64 vector in ``names`` order.  A
    model trained elsewhere passes its stored names; unknown names raise
    ``KeyError`` (schema drift must not silently mis-score)."""
    d = feature_dict(config, prog, graph, roles)
    if names is None:
        names = tuple(d)
    return np.array([d[n] for n in names], dtype=np.float64)


def artifact_features(art) -> dict[str, float]:
    """Descriptors of an already-compiled ``CompiledKernel`` — the resolved
    tile plan plus the schedule's measured op counts and bytes.  Used for
    model diagnostics (what did the schedule actually do) rather than
    candidate scoring, which must not pay for a compile."""
    feats: dict[str, float] = {
        "log_cost": _log10(1e12 * max(art.cost, 0.0)),
        "log_bytes_moved": _log10(art.bytes_moved),
        "n_instrs": float(len(art.instrs)),
    }
    for kind, n in sorted(art.counts.items()):
        feats[f"count={kind}"] = float(n)
    for plan in art.instrs:
        for axis, size in plan.tile:
            feats.setdefault(f"tile[{plan.needle}:{axis}]", float(size))
        feats.setdefault(f"calls[{plan.needle}]", float(plan.calls))
    return feats
