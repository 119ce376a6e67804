"""Ring collectives lowered to COPY streams over fabric links.

The lowering is algorithmic, not magical: an all-gather / reduce-scatter /
all-reduce over *p* chips becomes an explicit list of ``CollectiveStep``
sends — (step, src chip, dst chip, chunk, bytes) — that the fabric
simulator replays on per-link timelines with real dependencies (a chip can
only forward a chunk it has received; a reduce hop also waits for the
receiver's local partial).  Two algorithms:

  * ``ring``  — the classic unidirectional ring: p-1 serialized steps, each
                link carrying one chunk per step.
  * ``bidir`` — both ring directions at once.  All-gather halves the *step
                count* (a chunk only travels ceil((p-1)/2) hops); reduce-
                scatter halves the *per-step bytes* (each chunk splits into
                a clockwise and a counter-clockwise half).

Closed-form cost models (the textbook alpha-beta terms) are provided for
sanity checks and quick what-ifs; the simulator is the ground truth because
it sees link contention and compute/communication overlap.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

ALGORITHMS = ("ring", "bidir")

CW, CCW = 0, 1


@dataclass(frozen=True)
class CollectiveStep:
    """One chunk-send between ring-adjacent chips.

    ``src``/``dst`` are *positions in the ring order* resolved by the
    caller; ``direction`` separates the clockwise and counter-clockwise
    streams (distinct physical links); ``reduce`` marks hops that fold the
    arriving data into the receiver's local partial (reduce-scatter), which
    adds a dependency on that partial being computed.
    """

    phase: str
    step: int
    src: int
    dst: int
    chunk: int
    nbytes: int
    direction: int = CW
    reduce: bool = False


def _send(p: int, i: int, direction: int) -> int:
    return (i + 1) % p if direction == CW else (i - 1) % p


def lower_all_gather(p: int, chunk_nbytes: list[int], algorithm: str = "ring",
                     phase: str = "ag") -> list[CollectiveStep]:
    """Chunk *c* starts on chip *c* and must reach every chip."""
    if p <= 1:
        return []
    steps: list[CollectiveStep] = []
    if algorithm == "bidir":
        cw_hops = math.ceil((p - 1) / 2)
        ccw_hops = (p - 1) // 2
        for s in range(cw_hops):
            for i in range(p):
                c = (i - s) % p
                steps.append(CollectiveStep(phase, s, i, _send(p, i, CW), c,
                                            chunk_nbytes[c], CW))
        for s in range(ccw_hops):
            for i in range(p):
                c = (i + s) % p
                steps.append(CollectiveStep(phase, s, i, _send(p, i, CCW), c,
                                            chunk_nbytes[c], CCW))
    else:
        for s in range(p - 1):
            for i in range(p):
                c = (i - s) % p
                steps.append(CollectiveStep(phase, s, i, _send(p, i, CW), c,
                                            chunk_nbytes[c], CW))
    return steps


def lower_reduce_scatter(p: int, chunk_nbytes: list[int],
                         algorithm: str = "ring",
                         phase: str = "rs") -> list[CollectiveStep]:
    """Every chip holds a partial of every chunk; after the exchange chip
    *i* owns the fully reduced chunk ``(i+1) % p`` (cw half).  ``bidir``
    splits each chunk into a cw and a ccw half reduced simultaneously."""
    if p <= 1:
        return []
    steps: list[CollectiveStep] = []
    directions = ((CW, 1.0),) if algorithm != "bidir" \
        else ((CW, 0.5), (CCW, 0.5))
    for direction, frac in directions:
        for s in range(p - 1):
            for i in range(p):
                c = (i - s) % p if direction == CW else (i + s) % p
                nb = max(1, int(chunk_nbytes[c] * frac))
                steps.append(CollectiveStep(phase, s, i,
                                            _send(p, i, direction), c, nb,
                                            direction, reduce=True))
    return steps


def lower_all_reduce(p: int, chunk_nbytes: list[int],
                     algorithm: str = "ring",
                     phase: str = "ar") -> list[CollectiveStep]:
    """Reduce-scatter then all-gather of the reduced chunks.  The gather
    steps continue the per-(chunk, direction) chains started by the
    reduce — chip *i* owns cw-chunk ``(i+1) % p`` when the reduce ends, so
    the gather rotation starts there."""
    if p <= 1:
        return []
    steps = lower_reduce_scatter(p, chunk_nbytes, algorithm, phase)
    directions = {st.direction for st in steps} or {CW}
    for direction in sorted(directions):
        frac = 0.5 if len(directions) > 1 else 1.0
        for s in range(p - 1):
            for i in range(p):
                if direction == CW:
                    c = (i + 1 - s) % p
                else:
                    c = (i - 1 + s) % p
                nb = max(1, int(chunk_nbytes[c] * frac))
                steps.append(CollectiveStep(phase, (p - 1) + s, i,
                                            _send(p, i, direction), c, nb,
                                            direction, reduce=False))
    return steps


# --------------------------------------------------------------------------- #
# Closed-form alpha-beta cost models
# --------------------------------------------------------------------------- #


def all_gather_time(p: int, nbytes: int, bandwidth: float,
                    latency: float = 1e-6, algorithm: str = "ring") -> float:
    """Serialized ring steps of one chunk (= nbytes / p) each."""
    if p <= 1:
        return 0.0
    chunk = nbytes / p
    hops = math.ceil((p - 1) / 2) if algorithm == "bidir" else p - 1
    return hops * (latency + chunk / bandwidth)


def reduce_scatter_time(p: int, nbytes: int, bandwidth: float,
                        latency: float = 1e-6,
                        algorithm: str = "ring") -> float:
    if p <= 1:
        return 0.0
    chunk = nbytes / p
    if algorithm == "bidir":
        return (p - 1) * (latency + chunk / (2 * bandwidth))
    return (p - 1) * (latency + chunk / bandwidth)


def all_reduce_time(p: int, nbytes: int, bandwidth: float,
                    latency: float = 1e-6, algorithm: str = "ring") -> float:
    if p <= 1:
        return 0.0
    chunk = nbytes / p
    if algorithm == "bidir":
        return 2 * (p - 1) * (latency + chunk / (2 * bandwidth))
    return 2 * (p - 1) * (latency + chunk / bandwidth)
