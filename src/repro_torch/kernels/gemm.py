"""K1: the blocked GEMM, C = A @ B — the matmul instruction ISAM maps onto —
and K2: the fused instruction, C = act(A @ B + bias).

``gemm`` and ``gemm_bias_act`` launch the hand-written CUDA kernels in
``csrc/gemm.cu`` on CUDA tensors and run the plain versions
(``ref.gemm_ref``, ``ref.gemm_bias_act_ref``) on CPU tensors.  f32 and bf16
inputs accumulate in f32 and the result is returned in the input type.

Each launch takes one of two main loops, by a rule fixed before the launch
(``gemm_route``), never as a fallback:

* ``wgmma`` — the tensor cores, for bf16 with K % 8 == 0 and 16-byte
  aligned operands.  B first goes through one transposing pass, so both
  operands are K-major for TMA.
* ``simt`` — IEEE f32 FMA on the CUDA cores, for f32 (no TF32: the graph
  tier needs exact integer sums) and for every other bf16 GEMM.

``tile=(BM, BN, BK)`` is one block's tile and must be one the route is
built for (``ROUTES``).  ``tile=None`` takes the tile of the tuned block in
the port's tuning cache (``tuned_block``, mapped by ``block_tile``), and the
route's ``default_tile`` when the cache has no record for the shape.  When
a launch's output tiles are fewer than the card's SMs, K is split
(``split_k``): the main loop writes f32 partials of each K slice and a
reduce kernel sums them in slice order and applies the epilogue.  One C
call launches the whole sequence; ``gemm_transpose`` and ``gemm_reduce``
count the transposing passes and reduces it ran.

``projection`` is K2 without its rounding: A @ B + bias stored in f32 for
f32 or bf16 operands.  It is K4's input projection (``gru.gru_seq``), and
counts as a ``gemm_bias_act`` launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
import re
from dataclasses import dataclass

import torch

from ..core.sysgraph import GPU_SMS_PER_CLUSTER
from .cuda import check, library, ptxas_report, stream_handle
from .ref import gemm_bias_act_ref, gemm_ref

#: operand dtypes of the CUDA kernels, as the C entries' ``dtype`` arguments
#: (``csrc/gemm.cu`` and ``csrc/gru.cu``)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: K2's activations, as the kernel's ``act`` argument
ACTS = {"": 0, "sigmoid": 1, "tanh": 2, "relu": 3}
#: streaming multiprocessors of an H100 SXM, the card the plan targets
H100_SMS = 132
#: the fewest BK steps a split-K slice may have
MIN_SPLIT_STEPS = 4


@dataclass(frozen=True)
class Route:
    """One main loop of ``csrc/gemm.cu`` and the tiles it is built for."""

    name: str
    code: int                         # the C entry's ``route`` argument
    tile_m: tuple[int, ...]
    tile_n: tuple[int, ...]
    tile_k: tuple[int, ...]
    default_tile: tuple[int, int, int]
    stages: int                       # shared-memory pipeline depth

    def tiles(self) -> list[tuple[int, int, int]]:
        return [(bm, bn, bk) for bm in self.tile_m for bn in self.tile_n
                for bk in self.tile_k]

    def threads(self, tile) -> int:
        """Threads of one block.  wgmma: one consumer warpgroup per 64 rows
        plus the producer warpgroup.  simt: an 8 x 4 register tile per
        thread where BM and BN are both at least 64, else 256 threads."""
        bm, bn, _ = tile
        if self is WGMMA:
            return 128 * (bm // 64 + 1)
        return bm * bn // 32 if bm >= 64 and bn >= 64 else 256

    def smem_bytes(self, tile, dtype: torch.dtype) -> int:
        """Dynamic shared memory of one block (``csrc/gemm.cu``):
        ``stages`` x the A and B panels, plus, for wgmma, the full/empty
        mbarriers and 1024 B to align the ring to the 128-byte swizzle."""
        bm, bn, bk = tile
        if self is WGMMA:
            return 1024 + self.stages * (bm + bn) * bk * 2 + 2 * self.stages * 8
        esize = dtype.itemsize
        return self.stages * esize * (bm * (bk + 16 // esize) + bk * bn)


SIMT = Route("simt", 0, (16, 32, 64, 128), (16, 32, 64, 128), (32,),
             (64, 64, 32), 3)
WGMMA = Route("wgmma", 1, (64, 128), (16, 32, 64, 128, 256), (64,),
              (64, 64, 64), 4)
ROUTES = {r.name: r for r in (SIMT, WGMMA)}


def gemm_route(dtype: torch.dtype, k: int | None = None,
               aligned: bool = True) -> Route:
    """The rule: bf16 with a K-major row of 2K bytes that TMA takes
    (K % 8 == 0; ``k=None`` assumes so) and 16-byte aligned data pointers
    goes to ``wgmma``; everything else to ``simt``."""
    if dtype == torch.bfloat16 and aligned and (k is None or k % 8 == 0):
        return WGMMA
    return SIMT


def operand_route(a: torch.Tensor, b: torch.Tensor) -> Route:
    """``gemm_route`` of the operands A (M, K) and B (K, N)."""
    return gemm_route(a.dtype, a.shape[1],
                      a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


def pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def clamp_choice(x: int, choices: tuple[int, ...]) -> int:
    return min(max(x, choices[0]), choices[-1])


def route_tile(block, route: Route) -> tuple[int, int, int]:
    """The compiler's cluster block (bm, bn, bk) as one CUDA block's tile on
    ``route``.  The cluster's (bm, bn) output block is shared out over its
    16 SMs as a sqrt(16) x sqrt(16) = 4 x 4 arrangement; each share and the
    depth bk round up to a power of two and clamp to the route's built
    tiles."""
    bm, bn, bk = (int(v) for v in block)
    share = math.isqrt(GPU_SMS_PER_CLUSTER)
    return (clamp_choice(pow2_at_least(-(-bm // share)), route.tile_m),
            clamp_choice(pow2_at_least(-(-bn // share)), route.tile_n),
            clamp_choice(pow2_at_least(bk), route.tile_k))


def block_tile(block, dtype: torch.dtype = torch.float32,
               k: int | None = None) -> tuple[int, int, int]:
    """``route_tile`` on the route of ``dtype`` (and K, where given) — the
    one mapping behind ``ops.launch_config``, the tuned launch
    (``tile=None``) and the measured tuner."""
    return route_tile(block, gemm_route(dtype, k))


def split_k(m: int, n: int, k: int, tile, sms: int = H100_SMS) -> int:
    """How many K slices a launch takes: 1 when its output tiles fill the
    card's ``sms``; else about sms / tiles, so that tiles x S is at least
    the SM count and below twice it, with at most one slice per
    ``MIN_SPLIT_STEPS`` steps of depth BK.  A pure function of its
    arguments, not a knob."""
    bm, bn, bk = tile
    tiles = -(-m // bm) * -(-n // bn)
    if tiles >= sms:
        return 1
    return max(1, min(-(-sms // tiles), -(-k // bk) // MIN_SPLIT_STEPS))


@dataclass(frozen=True)
class Launch:
    """What one K1/K2 call launches."""

    route: str
    tile: tuple[int, int, int]
    split: int                    # K slices (gridDim.z); 1: no split
    grid: tuple[int, int]         # blocks over (M, N)
    threads: int
    smem_bytes: int


def gemm_launch(m: int, n: int, k: int, dtype: torch.dtype, tile,
                route: Route | None = None, sms: int = H100_SMS) -> Launch:
    """The launch of an (m, n, k) GEMM at ``tile`` on ``route`` (default:
    ``gemm_route(dtype, k)``), on a card with ``sms`` SMs."""
    route = route or gemm_route(dtype, k)
    tile = tuple(int(t) for t in tile)
    return Launch(route=route.name, tile=tile,
                  split=split_k(m, n, k, tile, sms),
                  grid=(-(-m // tile[0]), -(-n // tile[1])),
                  threads=route.threads(tile),
                  smem_bytes=route.smem_bytes(tile, dtype))


def kernel_resources(route: str, dtype: torch.dtype, tile) -> dict | None:
    """Registers, stack and spills of the main-loop instantiation a launch
    runs, from the ``-Xptxas -v`` log kept beside the built library;
    ``None`` when the log does not name it."""
    bm, bn, bk = tile
    if route == "wgmma":
        pat = rf"wgmma_kernelILi{bm}ELi{bn}E"
    else:
        t = "f" if dtype == torch.float32 else r"\d+__nv_bfloat16"
        pat = rf"simt_kernelI{t}Li{bm}ELi{bn}ELi{bk}E"
    found = [v for name, v in ptxas_report("gemm").items()
             if re.search(pat, name)]
    return found[0] if found else None


def tuned_record(m: int, n: int, k: int, graph=None):
    """The port's tuning-cache record of an (m, n, k) GEMM on ``graph``
    (default ``gpu_sm(8)``) — a ``measure`` record before a ``cost`` one —
    when it holds a block; ``None`` on a miss or an unreadable cache."""
    from ..search.cache import CACHE_ERRORS, lookup_gemm
    try:
        rec = lookup_gemm(m, n, k, graph)
    except CACHE_ERRORS:
        return None
    return rec if rec is not None and rec.tile else None


def tuned_block(m: int, n: int, k: int) -> tuple[int, int, int] | None:
    """The tuned (bm, bn, bk) block of an (m, n, k) GEMM (``tuned_record``),
    clamped to the problem; ``None`` when the cache has none."""
    from ..search.cache import clamp_tile
    rec = tuned_record(m, n, k)
    return None if rec is None else clamp_tile(rec.tile, m, n, k)


#: the C entry of ``csrc/gemm.cu``: dtype, C's dtype, route, BM, BN, BK,
#: split; A, B, Bt scratch, bias, act; C, workspace; m, n, k; stream
_ARGTYPES = ([ctypes.c_int] * 7 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = library("gemm").repro_gemm
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def device_sms(device: torch.device) -> int:
    """The SM count of a CUDA device (split-K's target)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


class Counter:
    """A launch count for a kernel that runs inside K1's and K2's launch
    sequence rather than behind a wrapper of its own."""

    launches = 0


#: the wgmma route's transposing pass of B, and split-K's reduce
gemm_transpose = Counter()
gemm_reduce = Counter()


def _check_tile(tile, route: Route) -> tuple[int, int, int]:
    bm, bn, bk = (int(t) for t in tile)
    if bm not in route.tile_m or bn not in route.tile_n \
            or bk not in route.tile_k:
        raise ValueError(f"gemm tile {tuple(tile)} not built for the "
                         f"{route.name} route: BM in {route.tile_m}, BN in "
                         f"{route.tile_n}, BK in {route.tile_k}")
    return bm, bn, bk


def _check_operands(name: str, a: torch.Tensor, b: torch.Tensor, tile
                    ) -> tuple[Route, tuple[int, int, int]]:
    """Shapes, dtypes and device of A, B and the tile (``None``: the tuned
    one) of one launch; returns the route and the checked tile."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name} shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError(f"{name} dtypes {a.dtype}, {b.dtype}: need one of "
                        f"{list(DTYPES)}")
    if a.device != b.device:
        raise ValueError(f"{name} operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {a.device}")
    m, k = a.shape
    n = b.shape[1]
    route = operand_route(a, b)
    if tile is None:
        block = tuned_block(m, n, k)
        tile = route.default_tile if block is None else route_tile(block,
                                                                   route)
    tile = _check_tile(tile, route)
    if a.device.type == "cuda":
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"{name} needs contiguous operands")
        if min(m, n, k) == 0:
            raise ValueError(f"{name} with an empty dimension: {m}x{n}x{k}")
    return route, tile


def _launch(name: str, a: torch.Tensor, b: torch.Tensor,
            bias: torch.Tensor | None, fn: str, route: Route,
            tile: tuple[int, int, int],
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One CUDA call of K1 or K2: one C call launches [the transposing pass
    of B], the main loop and [the split-K reduce]; both scratch buffers
    (Bt, the f32 partials) come from one allocation.  C is in
    ``out_dtype``: the input type (default) or f32."""
    m, k = a.shape
    n = b.shape[1]
    dev = a.device
    out_dtype = out_dtype or a.dtype
    split = split_k(m, n, k, tile, device_sms(dev))
    c = torch.empty((m, n), dtype=out_dtype, device=dev)
    bt_bytes = -(-2 * n * k // 256) * 256 if route is WGMMA else 0
    ws_bytes = 4 * split * m * n if split > 1 else 0
    scratch = torch.empty(bt_bytes + ws_bytes, dtype=torch.uint8, device=dev) \
        if bt_bytes + ws_bytes else None
    base = scratch.data_ptr() if scratch is not None else 0
    check(_kernel()(
        DTYPES[a.dtype], DTYPES[out_dtype], route.code, *tile, split,
        a.data_ptr(), b.data_ptr(),
        base if bt_bytes else None,
        None if bias is None else bias.data_ptr(), ACTS[fn], c.data_ptr(),
        base + bt_bytes if ws_bytes else None, m, n, k, stream_handle(dev)),
        name)
    gemm_transpose.launches += route is WGMMA
    gemm_reduce.launches += split > 1
    return c


def gemm(a: torch.Tensor, b: torch.Tensor,
         tile: tuple[int, int, int] | None = None) -> torch.Tensor:
    """C = A @ B for A (M, K) and B (K, N) of one dtype, f32 or bf16."""
    route, tile = _check_operands("gemm", a, b, tile)
    if a.device.type == "cpu":
        return gemm_ref(a, b)
    c = _launch("gemm", a, b, None, "", route, tile)
    gemm.launches += 1
    return c


def gemm_bias_act(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
                  fn: str = "",
                  tile: tuple[int, int, int] | None = None) -> torch.Tensor:
    """C = act(A @ B + bias) for A (M, K), B (K, N) of one dtype, f32 or
    bf16, and bias (N,) in f32 or that dtype; ``fn`` is one of "",
    "sigmoid", "tanh", "relu".  The sum, the bias and the activation are
    f32; the result is rounded to the input type once."""
    return _bias_act(a, b, bias, fn, tile, a.dtype)


def projection(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
               tile: tuple[int, int, int] | None = None) -> torch.Tensor:
    """A @ B + bias in f32, unrounded, for A (M, K), B (K, N) of one dtype,
    f32 or bf16: K2's launch (its route, tile and split) with an f32 store,
    counted as a ``gemm_bias_act`` launch."""
    return _bias_act(a, b, bias, "", tile, torch.float32)


def _bias_act(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor, fn: str,
              tile, out_dtype: torch.dtype) -> torch.Tensor:
    if fn not in ACTS:
        raise ValueError(f"gemm_bias_act activation {fn!r}: need one of "
                         f"{list(ACTS)}")
    route, tile = _check_operands("gemm_bias_act", a, b, tile)
    n = b.shape[1]
    if bias.shape != (n,) or bias.dtype not in (torch.float32, a.dtype) \
            or bias.device != a.device:
        raise ValueError(f"gemm_bias_act bias {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}: need ({n},) in "
                         f"float32 or {a.dtype} on {a.device}")
    if a.device.type == "cpu":
        return gemm_bias_act_ref(a, b, bias, fn, out_dtype)
    c = _launch("gemm_bias_act", a, b, bias.float().contiguous(), fn, route,
                tile, out_dtype)
    gemm_bias_act.launches += 1
    return c


gemm.launches = 0
gemm_bias_act.launches = 0
