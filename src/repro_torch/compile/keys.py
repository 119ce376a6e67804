"""Fingerprints and artifact keys for the compilation driver.

Cache keys must survive process restarts and distinguish programs/machines
structurally, so they hash ``Program.signature()`` and the system graph's
node/edge structure rather than relying on names alone.  The key is (program
fingerprint, sysgraph fingerprint, *approach* fingerprint, backend, ISA
fingerprint, transform policy, torch version): an artifact is reused only
when the whole compile is reproducible.
"""
from __future__ import annotations

import functools
import hashlib
import json

from ..core.ir import Program
from ..core.sysgraph import SystemGraph


def _short_hash(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


@functools.lru_cache(maxsize=512)
def program_fingerprint(prog: Program) -> str:
    """Stable structural hash of a haystack program (axes, buffers, access
    matrices) — survives renaming-free rebuilds across processes.  Cached
    (Program is frozen/hashable): artifact keying re-fingerprints the same
    program on every compile."""
    return _short_hash(prog.signature())


def sysgraph_fingerprint(graph: SystemGraph) -> str:
    """Structural hash of a system graph: target family, memory
    capacities/levels/roles, compute capabilities, and movement edges.
    Two targets that differ in any of these can never share an artifact."""
    parts = [graph.name, f"F{getattr(graph, 'family', 'generic')}"]
    for m in sorted(graph.memories.values(), key=lambda m: m.name):
        parts.append(f"M{m.name}:{m.capacity}:{m.level}:{m.role}")
    for c in sorted(graph.computes.values(), key=lambda c: c.name):
        parts.append(f"C{c.name}:{c.memory}:{sorted(c.instructions)}:"
                     f"{c.flops_per_sec}:{c.matmul_tile}:{c.vector_lanes}:"
                     f"{c.clock_hz}")
    for e in sorted(graph.edges, key=lambda e: (e.src, e.dst)):
        parts.append(f"E{e.src}>{e.dst}:{e.bandwidth}:{e.latency}")
    return _short_hash(";".join(parts))


@functools.lru_cache(maxsize=1)
def torch_version() -> str:
    """torch version without importing torch (keeps the compiler tier free
    of the tensor library)."""
    try:
        from importlib.metadata import version
        return version("torch")
    except Exception:  # pragma: no cover - metadata unavailable
        return "unknown"


def approach_fingerprint(approach) -> str:
    """Stable identity of an Approach for artifact keying.

    ``ParamApproach``-style approaches expose their config vector; the
    stateless heuristic approaches reduce to their class name.  Approaches
    with hidden state (wrappers, RNG-driven) get a non-reusable fingerprint
    so they are never served a memoized artifact."""
    cfg = getattr(approach, "config", None)
    if isinstance(cfg, dict):
        return "cfg:" + json.dumps(
            {k: cfg[k] for k in sorted(cfg)}, sort_keys=True)
    name = type(approach).__name__ if approach is not None else "GreedyApproach"
    if name in ("GreedyApproach", "Approach"):
        return "greedy"
    if name == "CostModelApproach":
        return f"costmodel:{getattr(approach, 'samples', 0)}" \
               f":{getattr(approach, 'seed', 0)}"
    return f"opaque:{name}:{id(approach)}"


def cacheable_approach(approach) -> bool:
    return not approach_fingerprint(approach).startswith("opaque:")


def isa_fingerprint(isa) -> str:
    """Structural hash of the needle set in play — two compiles of the same
    program under different ISAs must never share an artifact."""
    if not isa:
        return "-"
    parts = sorted(f"{n.name}@{program_fingerprint(n)}" for n in isa)
    return hashlib.sha256(";".join(parts).encode()).hexdigest()[:12]


def artifact_key_from_parts(prog_name: str, prog_fp: str, graph_name: str,
                            graph_fp: str, approach_fp: str, backend: str,
                            isa_fp: str = "-",
                            allow_transforms: bool = True) -> str:
    return (f"{prog_name}@{prog_fp}|{graph_name}@{graph_fp}"
            f"|{approach_fp}|{backend}|isa={isa_fp}"
            f"|xf={int(bool(allow_transforms))}|torch={torch_version()}")


def artifact_key(prog, graph: SystemGraph, approach, backend: str = "cost",
                 isa=None, allow_transforms: bool = True) -> str:
    """(program fp, sysgraph fp, approach fp, backend, isa fp, transform
    policy, torch version)."""
    return artifact_key_from_parts(prog.name, program_fingerprint(prog),
                                   graph.name, sysgraph_fingerprint(graph),
                                   approach_fingerprint(approach), backend,
                                   isa_fingerprint(isa), allow_transforms)
