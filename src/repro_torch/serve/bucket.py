"""Shape-bucketed warmup: the bucket lattice of pre-compiled block graphs.

Online serving cannot compile per request — it pads every prompt up to the
next bucket in a small seq-len lattice and replays that bucket's
pre-compiled whole-block ``CompiledGraph``.  ``ServingPool.warmup``
pre-traces and pre-compiles the full (arch × bucket) lattice through the
port's ``compile_graph`` and ``ArtifactCache``, against the port's default
target (``gpu_sm(8)``), so

  * identical kernel shapes dedupe *across* buckets and archs (every
    ``get_trace_config`` arch traces to the same block dims, so a second
    model family warms for free), and
  * a restart against the same cache file performs **zero** fresh compiles
    (``--expect-cached`` in the CLI).

Every artifact is re-verified at admission time — ``verify_graph`` +
``verify_placement`` on the compiled graph — before it may serve traffic;
a corrupt artifact is evicted and recompiled fresh (warn-once, never a
crash).  Each entry runs on the card through ``CompiledGraph.execute``
(its ``pallas_gpu_gemm`` nodes as K1 launches).  The pool itself stays
policy-free.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

#: default seq-len bucket lattice (powers of two keep padding waste <= 2x).
DEFAULT_BUCKETS = (4, 8, 16)

#: KV-cache element size: the trace configs are exact-f32 end to end.
_KV_ELEM_BYTES = 4

_warned_corrupt: set = set()


def bucket_for(prompt_len: int, buckets=DEFAULT_BUCKETS) -> int:
    """The smallest lattice bucket that fits ``prompt_len`` (pad-up
    routing).  A prompt beyond the largest bucket has no compiled shape."""
    for b in sorted(buckets):
        if prompt_len <= b:
            return int(b)
    raise ValueError(f"prompt_len {prompt_len} exceeds the largest bucket "
                     f"{max(buckets)}; widen the lattice")


def kv_bytes(cfg, bucket: int) -> int:
    """Modeled KV-cache footprint of one request padded to ``bucket``:
    K and V, per kv-head, per layer, f32."""
    return int(bucket * 2 * cfg.n_kv_heads * cfg.hd * _KV_ELEM_BYTES
               * cfg.n_layers)


@dataclass
class WarmedArtifact:
    """One serving-pool entry: the compiled block for (arch, bucket)."""

    arch: str
    bucket: int
    cg: object              # repro_torch.graph.CompiledGraph
    kv_bytes: int

    @property
    def makespan(self) -> float:
        return float(self.cg.makespan)


class ServingPool:
    """The warmed (arch × bucket) lattice of ``CompiledGraph`` artifacts.

    ``warmup()`` compiles the lattice (through ``cache`` when given) and
    admission-verifies every entry; ``route(request)`` returns the entry a
    request is served by.  ``admit`` is the verification gate and is public
    so corrupted artifacts (a bad cache payload, a hand-edited file) can be
    exercised directly.
    """

    def __init__(self, archs=("olmo-1b",), buckets=DEFAULT_BUCKETS, *,
                 cache=None, use_cache: bool | None = None,
                 fuse: bool = True):
        self.archs = tuple(archs)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.cache = cache
        self.use_cache = (cache is not None) if use_cache is None \
            else bool(use_cache)
        self.fuse = fuse
        self.entries: dict[tuple[str, int], WarmedArtifact] = {}
        self.stats: dict = {}

    # -- compilation ---------------------------------------------------------
    def _compile(self, arch: str, bucket: int, *, use_cache: bool):
        from ..configs.registry import get_trace_config
        from ..graph.compile import compile_graph
        from ..graph.fuse import fuse_epilogues
        from ..graph.trace import trace_block
        cfg = get_trace_config(arch)
        g = trace_block(cfg, seq_len=bucket)
        decisions = []
        if self.fuse:
            g, decisions = fuse_epilogues(g)
        cg = compile_graph(g, cache=self.cache, use_cache=use_cache,
                           decisions=decisions)
        return cfg, cg

    def admit(self, cg, arch: str, bucket: int):
        """Admission gate: re-verify a ``CompiledGraph`` before it may
        serve; corrupt → warn once, evict, recompile fresh (cache
        bypassed).  Returns the pooled ``WarmedArtifact``."""
        from ..configs.registry import get_trace_config
        from ..verify import DiagnosticReport, verify_graph, verify_placement
        report = DiagnosticReport()
        report.extend(verify_graph(cg.graph))
        if cg.placement is not None:
            report.extend(verify_placement(cg.graph, cg.placement.locations,
                                           cg.placement.budget))
        evicted = False
        if not report.ok:
            key = (arch, bucket)
            if key not in _warned_corrupt:
                _warned_corrupt.add(key)
                warnings.warn(
                    f"evicting corrupt serving artifact {arch}/T{bucket} "
                    f"({len(report.errors)} error(s): "
                    f"{report.errors[0].rule}); recompiling fresh")
            _, cg = self._compile(arch, bucket, use_cache=False)
            evicted = True
        cfg = get_trace_config(arch)
        art = WarmedArtifact(arch=arch, bucket=bucket, cg=cg,
                             kv_bytes=kv_bytes(cfg, bucket))
        self.entries[(arch, bucket)] = art
        if evicted:
            self.stats["evicted"] = self.stats.get("evicted", 0) + 1
        return art

    def warmup(self) -> dict:
        """Pre-compile + admission-verify the whole lattice.  Returns the
        aggregate stats the CLI/CI lanes assert on (fresh vs cached
        compiles, cross-bucket dedupe)."""
        fresh = hits = nodes = 0
        unique: set[str] = set()
        self.stats = {"evicted": 0}
        for arch in self.archs:
            for bucket in self.buckets:
                _, cg = self._compile(arch, bucket,
                                      use_cache=self.use_cache)
                self.admit(cg, arch, bucket)
                cg = self.entries[(arch, bucket)].cg
                fresh += cg.stats["fresh_compiles"]
                hits += cg.stats["cache_hits"]
                nodes += cg.stats["nodes"]
                unique.update(cg.kernels)
        self.stats.update({
            "archs": len(self.archs), "buckets": len(self.buckets),
            "entries": len(self.entries), "nodes": nodes,
            "unique_programs": len(unique),
            "fresh_compiles": fresh, "cache_hits": hits,
        })
        return dict(self.stats)

    # -- routing -------------------------------------------------------------
    def get(self, arch: str, bucket: int) -> WarmedArtifact:
        return self.entries[(arch, bucket)]

    def route(self, request) -> WarmedArtifact:
        """The entry serving ``request``: its arch at the pad-up bucket."""
        return self.get(request.arch, bucket_for(request.prompt_len,
                                                 self.buckets))
