"""Seeded request generators — the traffic side of ``repro_torch.serve``.

A ``Request`` is one inference call: it arrives at ``arrival`` seconds,
carries a ``prompt_len``-token prompt for one model family (``arch``) and
wants ``decode_len`` generated tokens.  Two arrival processes:

  * ``poisson`` — independent exponential inter-arrival gaps at ``rate``
    requests/second (the classic open-loop load model);
  * ``burst``   — requests arrive in simultaneous groups of ``burst_size``
    with exponential gaps *between* bursts, scaled so the long-run rate
    matches ``rate`` (the flash-crowd model).

Everything is drawn from one ``numpy.random.default_rng(seed)`` stream, so
a (seed, parameters) pair is bit-reproducible across machines, and the
same seed gives the same requests as the JAX package's generator.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np

#: prompt/decode length menus the generator samples from by default; the
#: prompt menu stays inside the default bucket lattice (bucket.py).
DEFAULT_PROMPT_LENS = (2, 4, 6, 8, 12, 16)
DEFAULT_DECODE_LENS = (1, 2, 3, 4, 6, 8)


@dataclass(frozen=True)
class Request:
    """One inference request."""

    rid: int
    arch: str
    arrival: float          # seconds since the start of the run
    prompt_len: int         # tokens to prefill
    decode_len: int         # tokens to generate after the prefill

    @property
    def tokens(self) -> int:
        """Total tokens this request is worth (prefill step + decodes)."""
        return self.prompt_len + self.decode_len

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Request":
        return cls(rid=int(d["rid"]), arch=str(d["arch"]),
                   arrival=float(d["arrival"]),
                   prompt_len=int(d["prompt_len"]),
                   decode_len=int(d["decode_len"]))


def generate_requests(n: int, *, seed: int = 0, rate: float = 100.0,
                      arrival: str = "poisson", burst_size: int = 4,
                      archs=("olmo-1b",),
                      prompt_lens=DEFAULT_PROMPT_LENS,
                      decode_lens=DEFAULT_DECODE_LENS) -> list[Request]:
    """``n`` seeded requests, sorted by (arrival, rid).

    ``rate`` is the mean arrival rate in requests/second for both
    processes; ``archs`` / ``prompt_lens`` / ``decode_lens`` are uniform
    menus.  Deterministic: one rng stream, fixed draw order.
    """
    if n <= 0:
        return []
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    if arrival == "poisson":
        gaps = rng.exponential(scale=1.0 / rate, size=n)
        arrivals = np.cumsum(gaps)
    elif arrival == "burst":
        n_bursts = (n + burst_size - 1) // burst_size
        gaps = rng.exponential(scale=burst_size / rate, size=n_bursts)
        starts = np.cumsum(gaps)
        arrivals = np.repeat(starts, burst_size)[:n]
    else:
        raise ValueError(f"unknown arrival process {arrival!r} "
                         "(pick 'poisson' or 'burst')")
    arch_idx = rng.integers(0, len(archs), size=n)
    p_idx = rng.integers(0, len(prompt_lens), size=n)
    d_idx = rng.integers(0, len(decode_lens), size=n)
    reqs = [Request(rid=i, arch=archs[int(arch_idx[i])],
                    arrival=float(arrivals[i]),
                    prompt_len=int(prompt_lens[int(p_idx[i])]),
                    decode_len=int(decode_lens[int(d_idx[i])]))
            for i in range(n)]
    reqs.sort(key=lambda r: (r.arrival, r.rid))
    return reqs


def percentile(values, p: float) -> float:
    """Deterministic linear-interpolation percentile (p in [0, 100]) —
    the p50/p99 the serve metrics report.  Plain python on a sorted copy
    so the result is identical wherever the floats are."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return 0.0
    if len(vals) == 1:
        return vals[0]
    pos = (p / 100.0) * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac
