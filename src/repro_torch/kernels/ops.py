"""The ISAM -> CUDA bridge: the compiler's plan becomes the kernels' launch.

``scheduled_gemm`` is the end-to-end story on the card: the compilation
driver (``repro_torch.compile``: map -> select -> schedule -> lower against
the modeled GPU, ``gpu_sm(8)``) decides the block, ``launch_config`` turns
that block into one CUDA block's tile, and K1 runs with it.  When the port's
tuning cache (``repro_torch.search``) holds a record for the shape, its
block — measured on the card by ``python -m repro_torch.search.tune
--backend measure`` — takes the compiler's place.  ``scheduled_gru`` does
the same for the GRU sequence (K4 over K3).

The GPU lowering (``pallas_gpu_gemm``) describes a thread-block *cluster*
of ``GPU_SMS_PER_CLUSTER`` = 16 SMs: its block fills the cluster's shared
memory (about 5.5x one block's 227 KB) and need not be a power of two.
The bridge shares the cluster's tile out over its 16 SMs and rounds each
share to the power of two the kernels are built for (``gemm.block_tile``).
Mapping the cluster block onto a real thread-block cluster is later work.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..compile import CompileError, compile_gemm, compile_gru
from ..core.sysgraph import GPU_SMS_PER_CLUSTER, SystemGraph
from .gemm import (THREADS, block_tile, clamp_choice, gemm, gemm_bias_act,
                   pow2_at_least, tuned_block, tuned_record)
from .gru import TILE_B, TILE_H, gru_cell, gru_seq

#: the largest shared memory one block can use on Hopper
MAX_SMEM_BYTES = 232_448


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class LaunchConfig:
    """One K1 launch derived from a ``pallas_gpu_gemm`` lowering."""

    block: tuple[int, int, int]   # the compiler's (cluster) block (bm, bn, bk)
    tile: tuple[int, int, int]    # one CUDA block's tile (BM, BN, BK)
    threads: int
    grid: tuple[int, int]         # CUDA blocks over (M, N) covering the plan
    smem_bytes: int               # one block's panels, for the dtype


def gemm_smem_bytes(tile: tuple[int, int, int], dtype: torch.dtype) -> int:
    """Shared memory of one K1 block: the (BM, BK + pad) A panel and the
    (BK, BN) B panel in the input type (``csrc/gemm.cu``)."""
    bm, bn, bk = tile
    esize = dtype.itemsize
    return esize * (bm * (bk + 4 // esize) + bk * bn)


def launch_config(lowering: dict, dtype: torch.dtype) -> LaunchConfig:
    """Map the compiler's cluster block to one CUDA block's tile
    (``gemm.block_tile``: a 4 x 4 share of the cluster's output block, each
    dim rounded up to a power of two and clamped to the built tiles).  So
    every tile dim is a power of two, at least 16 and at most max(16, the
    block dim rounded up to a power of two); shared memory is recomputed for
    ``dtype``; the grid covers the block x grid region of the lowering,
    hence M x N."""
    if lowering.get("kind") != "pallas_gpu_gemm":
        raise CompileError(f"not a GPU GEMM lowering: {lowering!r}")
    bm, bn, bk = (int(v) for v in lowering["block"])
    gm, gn, _ = (int(v) for v in lowering["grid"])
    tile = block_tile((bm, bn, bk))
    smem = gemm_smem_bytes(tile, dtype)
    if smem > MAX_SMEM_BYTES:
        raise CompileError(f"tile {tile} needs {smem} B of shared memory")
    grid = (_cdiv(gm * bm, tile[0]), _cdiv(gn * bn, tile[1]))
    return LaunchConfig(block=(bm, bn, bk), tile=tile, threads=THREADS,
                        grid=grid, smem_bytes=smem)


def gru_tile(block: tuple[int, int]) -> tuple[int, int]:
    """Map the compiler's GRU (batch, hidden) tile to one K3 block's tile.

    The batch tile stays whole in one block (splitting it would read every
    weight once more, and weights are what bound the step); the hidden tile
    is shared out over the cluster's 16 SMs.  Both round up to a power of
    two and clamp to the tiles K3 is built for."""
    bb, bh = (int(v) for v in block)
    return (clamp_choice(pow2_at_least(bb), TILE_B),
            clamp_choice(pow2_at_least(bh) // GPU_SMS_PER_CLUSTER, TILE_H))


def plan_gemm(m: int, n: int, k: int, dtype: torch.dtype = torch.float32,
              approach: str = "greedy", graph: SystemGraph | None = None,
              use_cache: bool = True) -> tuple[LaunchConfig, float]:
    """Compile an (m, n, k) GEMM against ``graph`` (default ``gpu_sm(8)``)
    through ``repro_torch.compile``; return (its K1 launch, modeled
    seconds).

    With ``use_cache`` (default), a record of the port's tuning cache for
    the shape short-circuits planning: its block (a ``measure`` record's
    before a ``cost`` one's, clamped to the problem) becomes the launch, and
    its modeled cost is returned as recorded.  The lookup happens on every
    call, so activating a cache mid-process takes effect at once."""
    rec = tuned_record(m, n, k, graph) if use_cache else None
    if rec is not None:
        from ..search.cache import clamp_tile
        block = clamp_tile(rec.tile, m, n, k)
        lowering = {"kind": "pallas_gpu_gemm", "block": list(block),
                    "grid": [_cdiv(e, b) for e, b in zip((m, n, k), block)]}
        return launch_config(lowering, dtype), rec.cost
    art = compile_gemm(m, n, k, approach=approach, graph=graph,
                       use_cache=use_cache)
    return launch_config(art.lowering, dtype), art.cost


def plan_gru(batch: int, hidden: int, inp: int | None = None,
             approach: str = "greedy", graph: SystemGraph | None = None
             ) -> tuple[tuple[int, int], float]:
    """Compile the GRU cell through ``repro_torch.compile``; return the
    (bb, bh) batch/hidden tile of its matmul stage + the modeled seconds.
    Raises ``CompileError`` if no matmul-shaped instruction was
    selected."""
    art = compile_gru(batch, hidden, inp, approach=approach, graph=graph)
    for prefix in ("fused.matmul", "mxu.matmul"):
        try:
            plan = art.instr_plan(prefix)
            return (plan.tile_for("i"), plan.tile_for("j")), art.cost
        except CompileError:
            continue
    raise CompileError(
        f"GRU selection contains no matmul-shaped instruction "
        f"(have: {[p.needle for p in art.instrs]})")


def scheduled_gemm(a: torch.Tensor, b: torch.Tensor,
                   graph: SystemGraph | None = None
                   ) -> tuple[torch.Tensor, LaunchConfig]:
    """GEMM whose tile was chosen by the compilation driver; returns the
    product and the launch (compiler block and CUDA tile)."""
    m, k = a.shape
    _, n = b.shape
    cfg, _ = plan_gemm(m, n, k, dtype=a.dtype, graph=graph)
    return gemm(a, b, tile=cfg.tile), cfg


def scheduled_gru(xs: torch.Tensor, h0: torch.Tensor, gru,
                  graph: SystemGraph | None = None) -> torch.Tensor:
    """GRU sequence xs [T, B, E] from h0 [B, H] with the weights of ``gru``
    (a ``FusedGRU``), tiled as the compilation driver planned the cell."""
    _, batch, inp = xs.shape
    block, _ = plan_gru(batch, h0.shape[1], inp, graph=graph)
    return gru_seq(xs, h0, gru.params(), tile=gru_tile(block))


__all__ = [
    "LaunchConfig", "gemm", "gemm_bias_act", "gru_cell", "gru_seq",
    "gru_tile", "launch_config", "plan_gemm", "plan_gru", "scheduled_gemm",
    "scheduled_gru", "tuned_block",
]
