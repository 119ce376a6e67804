"""The searchable mapping/schedule space (paper Section 4).

``ParamApproach`` turns the Approach interface into data: every decision the
compiler routes through an Approach — tile shapes, reduction streaming,
staging budget, unroll order, device allocation, copy-source choice — is
driven by one explicit config vector (a flat ``dict``).  ``SearchSpace``
enumerates and mutates those vectors; the strategies in ``strategies.py``
never need to know what the dimensions mean.

The distinguished ``baseline()`` point reproduces ``GreedyApproach``
*exactly*, which gives every search a sound anchor: a tuner that evaluates
the baseline first can never report a config worse than the paper's
heuristics.

Fingerprinting: tuning keys hash ``Program.signature()`` and the system
graph's structure with the same fingerprints the compilation driver keys
its artifacts on (``compile.keys``).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator, Mapping

from ..compile.keys import (program_fingerprint, sysgraph_fingerprint,
                            torch_version)
from ..core.approach import (Approach, DEVICE_POLICIES, SOURCE_POLICIES,
                             UNROLL_POLICIES)
from ..core.ir import Program
from ..core.sysgraph import SystemGraph

Config = dict   # a point in the space: {axis name -> value}


# --------------------------------------------------------------------------- #
# ParamApproach — config-vector-driven Approach
# --------------------------------------------------------------------------- #


class ParamApproach(Approach):
    """An Approach whose decision points are set from a config vector.

    Missing keys fall back to the greedy defaults, so configs stored by
    older caches (or hand-written partial configs) keep working.
    """

    def __init__(self, config: Mapping | None = None):
        cfg = dict(config or {})
        self.config = cfg

        def _cap(v):
            return int(v) if isinstance(v, (int, float)) and v else None

        self.tile_caps = (_cap(cfg.get("tile_i")), _cap(cfg.get("tile_j")),
                          _cap(cfg.get("tile_k")))
        self.stream_k = self.tile_caps[2] is None
        try:
            frac = float(cfg.get("vmem_frac", 1.0))
        except (TypeError, ValueError):
            frac = 1.0
        self.vmem_frac = frac if 0.0 < frac <= 1.0 else 1.0
        self.grow_j = bool(cfg.get("grow_j", True))
        # Unknown policy names (e.g. records written by a newer version)
        # fall back to the greedy defaults — cache reads stay tolerant.
        self.unroll_policy = cfg.get("unroll", "out_major")
        if self.unroll_policy not in UNROLL_POLICIES:
            self.unroll_policy = "out_major"
        self.device_policy = cfg.get("device", "locality")
        if self.device_policy not in DEVICE_POLICIES:
            self.device_policy = "locality"
        self.source_policy = cfg.get("source", "cheapest")
        if self.source_policy not in SOURCE_POLICIES:
            self.source_policy = "cheapest"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ParamApproach({self.config!r})"


# --------------------------------------------------------------------------- #
# SearchSpace
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class SpaceAxis:
    """One named decision dimension and its finite choice set."""

    name: str
    choices: tuple


class SearchSpace:
    """Finite, enumerable space of Approach config vectors.

    Tile choices are derived from the target's hardware matmul tile: caps
    below the hardware shape only waste matrix-unit passes (the cost model
    charges whole passes), so the space spans [hw, 4*hw] for output dims and
    [hw, 8*hw] or budget-streaming for the reduction.
    """

    def __init__(self, hw_tile: tuple[int, int, int] = (128, 128, 128)):
        ti, tj, tk = hw_tile
        self.hw_tile = hw_tile
        self.axes: tuple[SpaceAxis, ...] = (
            SpaceAxis("tile_i", (None, ti, 2 * ti, 4 * ti)),
            SpaceAxis("tile_j", (None, tj, 2 * tj, 4 * tj)),
            SpaceAxis("tile_k", (None, tk, 2 * tk, 4 * tk, 8 * tk)),
            SpaceAxis("vmem_frac", (1.0, 0.5, 0.25)),
            SpaceAxis("grow_j", (True, False)),
            SpaceAxis("unroll", tuple(UNROLL_POLICIES)),
            SpaceAxis("device", DEVICE_POLICIES),
            SpaceAxis("source", SOURCE_POLICIES),
        )
        self._by_name = {a.name: a for a in self.axes}

    @classmethod
    def for_graph(cls, graph: SystemGraph) -> "SearchSpace":
        return cls(graph.min_matmul_tile())

    # -- points --------------------------------------------------------------
    def baseline(self) -> Config:
        """The greedy-equivalent point: ParamApproach(baseline()) makes the
        same decisions as GreedyApproach on every program."""
        return {"tile_i": None, "tile_j": None, "tile_k": None,
                "vmem_frac": 1.0, "grow_j": True, "unroll": "out_major",
                "device": "locality", "source": "cheapest"}

    def random_config(self, rng: random.Random) -> Config:
        return {a.name: rng.choice(a.choices) for a in self.axes}

    def mutate(self, config: Config, rng: random.Random,
               n_mutations: int = 1) -> Config:
        """Flip ``n_mutations`` randomly chosen dimensions to new values."""
        out = dict(config)
        for _ in range(max(1, n_mutations)):
            ax = rng.choice(self.axes)
            alts = [c for c in ax.choices if c != out.get(ax.name)]
            if alts:
                out[ax.name] = rng.choice(alts)
        return out

    def crossover(self, a: Config, b: Config, rng: random.Random) -> Config:
        """Uniform crossover of two parent configs."""
        return {ax.name: (a if rng.random() < 0.5 else b).get(ax.name)
                for ax in self.axes}

    def neighbors(self, config: Config) -> Iterator[Config]:
        """All single-dimension mutations, in deterministic order."""
        for ax in self.axes:
            for c in ax.choices:
                if c != config.get(ax.name):
                    yield {**config, ax.name: c}

    def size(self) -> int:
        n = 1
        for a in self.axes:
            n *= len(a.choices)
        return n

    def enumerate_configs(self) -> Iterator[Config]:
        """Every point of the space, in deterministic (axis-major) order —
        what the surrogate strategy ranks when the space is small enough to
        score exhaustively (a prediction costs microseconds, so even ~10^4
        points are cheap to rank)."""
        import itertools
        names = [a.name for a in self.axes]
        for values in itertools.product(*(a.choices for a in self.axes)):
            yield dict(zip(names, values))

    def to_approach(self, config: Config) -> ParamApproach:
        return ParamApproach(config)


def config_key(config: Config) -> tuple:
    """Hashable canonical form of a config vector (for dedup / storage)."""
    return tuple(sorted(config.items()))


def tuning_key(prog: Program, graph: SystemGraph | str,
               backend: str = "cost") -> str:
    """Persistent cache key: (program fingerprint, sysgraph, backend,
    torch version) per the tuning-cache contract."""
    if isinstance(graph, SystemGraph):
        gname = f"{graph.name}@{sysgraph_fingerprint(graph)}"
    else:
        gname = graph
    return (f"{prog.name}@{program_fingerprint(prog)}|{gname}"
            f"|{backend}|torch={torch_version()}")
