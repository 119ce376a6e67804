"""Roofline terms for the dry run: the JAX package's
``launch/hlo_analysis.py`` from ``CollectiveStats`` on, byte for byte
(``CollectiveStats``, ``PEAK_FLOPS``/``HBM_BW``/``ICI_BW``,
``TARGET_ROOFLINES`` and ``roofline_terms``).

``shape_bytes`` and ``parse_collectives`` read XLA's HLO text, which the
port never has; its dry run counts collectives from the aten ops of a
traced step (``launch.op_flops``) into a ``CollectiveStats``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.sysgraph import GPU_HBM_BW, GPU_NVLINK_BW, GPU_PEAK_FLOPS


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def as_dict(self) -> dict:
        return {"total_bytes": self.total_bytes,
                "total_count": self.total_count,
                "bytes_by_kind": dict(self.bytes_by_kind),
                "count_by_kind": dict(self.count_by_kind)}


# --------------------------------------------------------------------------- #
# Roofline terms (v5e constants; see DESIGN.md §7)
# --------------------------------------------------------------------------- #

PEAK_FLOPS = 197e12         # bf16 / chip
HBM_BW = 819e9              # bytes/s / chip
ICI_BW = 50e9               # bytes/s / link

#: --target name -> (peak FLOP/s, HBM bytes/s, interconnect bytes/s) per
#: chip/device — the modeled machines of ``core.sysgraph``.  The dry-run
#: driver selects a row so the same lowered HLO yields a per-target
#: roofline (the nightly cross-backend sweep).
TARGET_ROOFLINES = {
    "tpu_v5e": (PEAK_FLOPS, HBM_BW, ICI_BW),
    "gpu_sm": (GPU_PEAK_FLOPS, GPU_HBM_BW, GPU_NVLINK_BW),
}


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   chips: int, target: str = "tpu_v5e") -> dict:
    peak, hbm_bw, link_bw = TARGET_ROOFLINES.get(
        target, TARGET_ROOFLINES["tpu_v5e"])
    compute_s = flops / (chips * peak)
    memory_s = hbm_bytes / (chips * hbm_bw)
    collective_s = collective_bytes / (chips * link_bw)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom
    terms["roofline_s"] = bound
    terms["roofline_fraction_compute"] = (
        compute_s / bound if bound > 0 else 0.0)
    return terms
