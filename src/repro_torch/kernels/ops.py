"""The ISAM -> CUDA bridge: the compiler's plan becomes the kernels' launch.

``scheduled_gemm`` is the end-to-end story on the card: the compilation
driver (``repro_torch.compile``: map -> select -> schedule -> lower against
the modeled GPU, ``gpu_sm(8)``) decides the block, ``launch_config`` turns
that block into one CUDA block's tile, and K1 runs with it.  When the port's
tuning cache (``repro_torch.search``) holds a record for the shape, its
block — measured on the card by ``python -m repro_torch.search.tune
--backend measure`` — takes the compiler's place.  ``scheduled_gru`` does
the same for the GRU sequence's input projection (K2, before K4's
recurrence); ``gru_tile`` maps the compiler's GRU plan to K3's tile.
``scheduled_conv`` runs the paper's conv-to-GEMM extraction: the conv
frontend (``compile_conv``) fuses a stride-1 1x1 convolution's batch, y
and x into one GEMM axis, and K1 runs that GEMM on views of the NHWC
activation and the filter at the block of the extraction's matmul plan.

The GPU lowering (``pallas_gpu_gemm``) describes a thread-block *cluster*
of ``GPU_SMS_PER_CLUSTER`` = 16 SMs: its block fills the cluster's shared
memory (about 5.5x one block's 227 KB) and need not be a power of two.
The bridge shares the cluster's tile out over its 16 SMs and rounds each
share to the power of two the kernels are built for (``gemm.route_tile``),
on the main loop the dtype and K take (``gemm.gemm_route``).
Mapping the cluster block onto a real thread-block cluster is later work.
"""
from __future__ import annotations

import functools
import math
from dataclasses import asdict, dataclass

import torch

from ..compile import CompileError, compile_conv, compile_gemm, compile_gru
from ..core.sysgraph import GPU_SMS_PER_CLUSTER, SystemGraph
from ..telemetry import count, span
from .cuda import MAX_SMEM_BYTES
from .gemm import (Launch, Route, clamp_choice, gemm, gemm_bias_act,
                   gemm_launch, gemm_route, operand_route, pow2_at_least,
                   route_tile, tuned_block, tuned_record)
from .gru import TILE_B, TILE_H, gru_cell, gru_seq


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _block_lowering(block, shape) -> dict:
    """The ``pallas_gpu_gemm`` lowering of ``block`` over the (m, n, k)
    ``shape``."""
    return {"kind": "pallas_gpu_gemm", "block": list(block),
            "grid": [_cdiv(e, b) for e, b in zip(shape, block)]}


@dataclass(frozen=True)
class LaunchConfig(Launch):
    """One K1 launch derived from a ``pallas_gpu_gemm`` lowering: the
    compiler's (cluster) block (bm, bn, bk) and the launch it maps to."""

    block: tuple[int, int, int]


def launch_config(lowering: dict, dtype: torch.dtype,
                  shape: tuple[int, int, int] | None = None,
                  route: Route | None = None) -> LaunchConfig:
    """Map the compiler's cluster block to one CUDA block's launch.

    ``shape`` is the (m, n, k) problem (default: the region the lowering's
    block x grid covers) and ``route`` the main loop (default:
    ``gemm_route(dtype, k)``).  The tile is ``gemm.route_tile`` of the
    block: a 4 x 4 share of the cluster's output block, each dim rounded up
    to a power of two and clamped to the route's built tiles.  Threads,
    shared memory (``Route.smem_bytes``), the grid over the problem and the
    split-K slices (``gemm.split_k`` on an H100's SMs) follow the kernel.
    A pure function of its arguments, derived once per (block, shape,
    dtype, route)."""
    if lowering.get("kind") != "pallas_gpu_gemm":
        raise CompileError(f"not a GPU GEMM lowering: {lowering!r}")
    block = tuple(int(v) for v in lowering["block"])
    shape = tuple(shape or (int(g) * b for g, b in
                            zip(lowering["grid"], block)))
    return _launch_config(block, shape, dtype, route)


@functools.lru_cache(maxsize=512)
def _launch_config(block: tuple[int, int, int], shape: tuple[int, int, int],
                   dtype: torch.dtype, route: Route | None) -> LaunchConfig:
    m, n, k = shape
    route = route or gemm_route(dtype, k)
    launch = gemm_launch(m, n, k, dtype, route_tile(block, route), route)
    if launch.smem_bytes > MAX_SMEM_BYTES:
        raise CompileError(f"tile {launch.tile} needs {launch.smem_bytes} B "
                           f"of shared memory")
    return LaunchConfig(block=block, **asdict(launch))


def gru_tile(block: tuple[int, int]) -> tuple[int, int]:
    """Map the compiler's GRU (batch, hidden) tile to one K3 block's tile.

    The cluster's tile is shared out over its 16 SMs as sqrt(16) x
    sqrt(16) = 4 x 4, as ``gemm.route_tile`` shares a GEMM block: the
    hidden tile takes a quarter, and the batch tile stays whole in one
    block (splitting it would read every weight once more, and weights are
    what bound the step; K3's split over the reduction supplies the
    blocks).  Both round up to a power of two and clamp to the tiles K3 is
    built for."""
    bb, bh = (int(v) for v in block)
    share = math.isqrt(GPU_SMS_PER_CLUSTER)
    return (clamp_choice(pow2_at_least(bb), TILE_B),
            clamp_choice(pow2_at_least(-(-bh // share)), TILE_H))


def plan_gemm(m: int, n: int, k: int, dtype: torch.dtype = torch.float32,
              graph: SystemGraph | None = None, use_cache: bool = True,
              route: Route | None = None) -> tuple[LaunchConfig, float]:
    """Compile an (m, n, k) GEMM against ``graph`` (default ``gpu_sm(8)``)
    through ``repro_torch.compile``; return (its K1 launch on ``route``,
    default ``gemm_route(dtype, k)``, and the modeled seconds).

    With ``use_cache`` (default), a record of the port's tuning cache for
    the shape short-circuits planning: its block (a ``measure`` record's
    before a ``cost`` one's, clamped to the problem) becomes the launch, and
    its modeled cost is returned as recorded.  The lookup happens on every
    call, before the compiler's memos are asked, so activating a cache
    mid-process takes effect at once.  A warm call with no record is a hit
    of the compiler's signature memo (``repro_torch.compile.driver``) and
    of the launch memo behind ``launch_config``."""
    with span("ops.plan"):
        with span("plan.tuned"):
            rec = tuned_record(m, n, k, graph) if use_cache else None
        if rec is not None:
            from ..search.cache import clamp_tile
            lowering = _block_lowering(clamp_tile(rec.tile, m, n, k),
                                       (m, n, k))
            cost = rec.cost
        else:
            art = compile_gemm(m, n, k, approach="greedy", graph=graph,
                               use_cache=use_cache)
            lowering, cost = art.lowering, art.cost
        with span("plan.launch"):
            return launch_config(lowering, dtype, (m, n, k), route), cost


def plan_gru(batch: int, hidden: int, inp: int | None = None,
             graph: SystemGraph | None = None
             ) -> tuple[tuple[int, int], float]:
    """Compile the GRU cell through ``repro_torch.compile``; return the
    (bb, bh) batch/hidden tile of its matmul stage + the modeled seconds.
    Raises ``CompileError`` if no matmul-shaped instruction was
    selected."""
    with span("ops.plan"):
        art = compile_gru(batch, hidden, inp, approach="greedy", graph=graph)
        with span("plan.launch"):
            for prefix in ("fused.matmul", "mxu.matmul"):
                try:
                    plan = art.instr_plan(prefix)
                    return (plan.tile_for("i"), plan.tile_for("j")), art.cost
                except CompileError:
                    continue
    raise CompileError(
        f"GRU selection contains no matmul-shaped instruction "
        f"(have: {[p.needle for p in art.instrs]})")


def conv_gemm(art, batch: int, h: int, w: int, cin: int, cout: int
              ) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """The GEMM a conv artifact's extraction is: (its block, (m, n, k)).

    The selection must be one ``mxu.matmul`` call that covers the whole
    convolution, with ``i`` on batch, y and x fused in NHWC order (``byx``;
    those of extent 1 are dropped before the fusion), ``j`` on ``co`` and
    ``k`` on ``ci``: then (m, n, k) is (batch·h·w, cout, cin) and the
    block is the plan's ``gemm_tile()`` clamped to it.  Any other selection
    (a stride, a kernel wider than 1x1, more calls, another axis order)
    raises ``CompileError``."""
    plans = art.instrs
    p = plans[0] if len(plans) == 1 else None
    fused = ("b" * (batch != 1)) + ("y" * (h != 1)) + ("x" * (w != 1))
    if (p is None or not p.needle.startswith("mxu.matmul") or p.calls != 1
            or p.outer_axes
            or dict(p.axis_map) != {"i": fused, "j": "co", "k": "ci"}):
        raise CompileError(f"the conv's extraction is not one GEMM: "
                           f"{[q.to_dict() for q in plans]}")
    m, n, k = shape = (batch * h * w, cout, cin)
    tile = dict(p.tile)
    return (min(tile["i"], m), min(tile["j"], n), min(tile["k"], k)), shape


def plan_conv(batch: int, h: int, w: int, cin: int, cout: int,
              dtype: torch.dtype = torch.float32,
              graph: SystemGraph | None = None, route: Route | None = None,
              *, kh: int = 1, kw: int = 1) -> tuple[LaunchConfig, float]:
    """Compile a stride-1 ``kh`` x ``kw`` convolution of ``batch`` x ``h``
    x ``w`` outputs, ``cin`` to ``cout`` channels, through the conv
    frontend (``compile_conv``, greedy, against ``graph``, default
    ``gpu_sm(8)``); return (the K1 launch of the GEMM its extraction is, on
    ``route``, default ``gemm_route(dtype, cin)``, and the modeled
    seconds).

    The block is the extraction's own matmul plan (``conv_gemm``), never
    the tuning cache's, and the artifact's lowering is not read.  A
    convolution whose extraction is not one GEMM raises ``CompileError``,
    and nothing falls back.  A warm call is a hit of the compiler's
    signature memo and of the launch memo behind ``launch_config``."""
    with span("ops.plan"):
        art = compile_conv(approach="greedy", graph=graph, batch=batch, h=h,
                           w=w, kh=kh, kw=kw, cin=cin, cout=cout)
        with span("plan.extract"):
            block, shape = conv_gemm(art, batch, h, w, cin, cout)
        with span("plan.launch"):
            return _launch_config(block, shape, dtype, route), art.cost


def scheduled_gemm(a: torch.Tensor, b: torch.Tensor,
                   graph: SystemGraph | None = None
                   ) -> tuple[torch.Tensor, LaunchConfig]:
    """GEMM whose tile was chosen by the compilation driver; returns the
    product and the launch (compiler block and CUDA tile)."""
    with span("ops.gemm"):
        m, k = a.shape
        _, n = b.shape
        cfg, _ = plan_gemm(m, n, k, dtype=a.dtype, graph=graph,
                           route=operand_route(a, b))
        return gemm(a, b, tile=cfg.tile), cfg


def scheduled_conv(x: torch.Tensor, w: torch.Tensor,
                   graph: SystemGraph | None = None
                   ) -> tuple[torch.Tensor, LaunchConfig]:
    """The stride-1 convolution of the NHWC activation ``x`` ``[B, H, W,
    Cin]`` by the filter ``w`` ``[kh, kw, Cin, Cout]`` (ISAMIR's
    ``conv2d`` layout) as one K1 GEMM at ``plan_conv``'s launch; returns
    the NHWC output and the launch.

    K1 reads ``x`` as its (B·H·W, Cin) view and ``w`` as its (Cin, Cout)
    view and writes the output whose ``[B, H, W, Cout]`` view is returned:
    nothing is copied, so a non-contiguous ``x`` or ``w`` raises
    ``CompileError``, as does a filter wider than 1x1 (``plan_conv``).
    Counts ``conv.gemm`` once a convolution run."""
    with span("ops.conv"):
        if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
            raise ValueError(f"conv of {tuple(x.shape)} by {tuple(w.shape)}:"
                             f" need x [B, H, W, Cin], w [kh, kw, Cin, Cout]")
        if not (x.is_contiguous() and w.is_contiguous()):
            raise CompileError("the conv's GEMM reads views of x and w: "
                               "both must be contiguous")
        batch, hi, wi, cin = x.shape
        kh, kw, _, cout = w.shape
        h, wo = hi - kh + 1, wi - kw + 1
        a, b = x.view(-1, cin), w.view(-1, cout)
        cfg, _ = plan_conv(batch, h, wo, cin, cout, dtype=x.dtype,
                           graph=graph, route=operand_route(a, b), kh=kh,
                           kw=kw)
        y = gemm(a, b, tile=cfg.tile)
        count("conv.gemm")
        return y.view(batch, h, wo, cout), cfg


def scheduled_gru(xs: torch.Tensor, h0: torch.Tensor, gru,
                  graph: SystemGraph | None = None) -> torch.Tensor:
    """GRU sequence xs [T, B, E] from h0 [B, H] with the weights of ``gru``
    (a ``FusedGRU``).  On K4's persistent route the input projection of all
    T steps is a (T B, 3H, E) GEMM, and K2 runs it at the tile
    ``plan_gemm`` gives: the tuning cache's record where there is one, else
    the compilation driver's plan.  On its step route K3 runs each step at
    the tile of the compiler's GRU plan (``gru_tile``)."""
    with span("ops.gru"):
        steps, batch, inp = xs.shape
        hidden = h0.shape[1]
        cfg, _ = plan_gemm(steps * batch, 3 * hidden, inp, dtype=xs.dtype,
                           graph=graph)
        block, _ = plan_gru(batch, hidden, inp, graph=graph)
        return gru_seq(xs, h0, gru.params(), proj_tile=cfg.tile,
                       step_tile=gru_tile(block))


__all__ = [
    "LaunchConfig", "conv_gemm", "gemm", "gemm_bias_act",
    "gru_cell", "gru_seq", "gru_tile", "launch_config", "plan_conv",
    "plan_gemm", "plan_gru", "scheduled_conv", "scheduled_gemm",
    "scheduled_gru", "tuned_block",
]
