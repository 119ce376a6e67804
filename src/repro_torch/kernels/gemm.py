"""K1: the blocked GEMM, C = A @ B — the matmul instruction ISAM maps onto —
and K2: the fused instruction, C = act(A @ B + bias).

``gemm`` and ``gemm_bias_act`` launch the hand-written CUDA kernels in
``csrc/gemm.cu`` on CUDA tensors and run the plain versions
(``ref.gemm_ref``, ``ref.gemm_bias_act_ref``) on CPU tensors.
``tile=(BM, BN, BK)`` is one block's tile.  ``tile=None`` takes the tile of
the tuned block in the port's tuning cache (``tuned_block``, mapped by
``block_tile``), and ``DEFAULT_TILE`` when the cache has no record for the
shape.  f32 and bf16 inputs accumulate in f32 and the result is returned in
the input type.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core.sysgraph import GPU_SMS_PER_CLUSTER
from .cuda import check, library, stream_handle
from .ref import gemm_bias_act_ref, gemm_ref

#: tile dims the CUDA library is built for
TILE_MN = (16, 32, 64, 128)
TILE_K = (16, 32)
THREADS = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DEFAULT_TILE = (64, 64, 32)
#: K2's activations, as the kernel's ``act`` argument
ACTS = {"": 0, "sigmoid": 1, "tanh": 2, "relu": 3}


def pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def clamp_choice(x: int, choices: tuple[int, ...]) -> int:
    return min(max(x, choices[0]), choices[-1])


def block_tile(block) -> tuple[int, int, int]:
    """Map the compiler's cluster block (bm, bn, bk) to one CUDA block's
    tile — the one mapping behind ``ops.launch_config``, the tuned launch
    (``tile=None``) and the measured tuner.

    The cluster's (bm, bn) output block is shared out over its 16 SMs as a
    sqrt(16) x sqrt(16) = 4 x 4 arrangement; each share and the reduction
    depth bk round up to a power of two and clamp to the tiles the kernels
    are built for (BM, BN in 16..128, BK in 16..32)."""
    bm, bn, bk = (int(v) for v in block)
    split = math.isqrt(GPU_SMS_PER_CLUSTER)
    return (clamp_choice(pow2_at_least(-(-bm // split)), TILE_MN),
            clamp_choice(pow2_at_least(-(-bn // split)), TILE_MN),
            clamp_choice(pow2_at_least(bk), TILE_K))


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


#: C entries of ``csrc/gemm.cu``: (dtype, BM, BN, BK[, act]), the pointers
#: (A, B[, bias], C), (m, n, k) and the stream
_ARGTYPES = {
    "repro_gemm": [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "repro_gemm_bias_act": [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(library("gemm"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_tile(tile) -> tuple[int, int, int]:
    bm, bn, bk = (int(t) for t in tile)
    if bm not in TILE_MN or bn not in TILE_MN or bk not in TILE_K:
        raise ValueError(f"gemm tile {tuple(tile)} not built: BM, BN in "
                         f"{TILE_MN}, BK in {TILE_K}")
    return bm, bn, bk


def _check_operands(name: str, a: torch.Tensor, b: torch.Tensor, tile
                    ) -> tuple[int, int, int]:
    """Shapes, dtypes and device of A, B and the tile (``None``: the tuned
    one) of one launch; returns the checked tile."""
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
    if tile is None:
        block = tuned_block(m, n, k)
        tile = DEFAULT_TILE if block is None else block_tile(block)
    tile = _check_tile(tile)
    if a.device.type == "cuda":
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"{name} needs contiguous operands")
        if min(m, n, k) == 0:
            raise ValueError(f"{name} with an empty dimension: {m}x{n}x{k}")
    return tile


def gemm(a: torch.Tensor, b: torch.Tensor,
         tile: tuple[int, int, int] | None = None) -> torch.Tensor:
    """C = A @ B for A (M, K) and B (K, N) of one dtype, f32 or bf16."""
    bm, bn, bk = _check_operands("gemm", a, b, tile)
    if a.device.type == "cpu":
        return gemm_ref(a, b)
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    check(_kernel("repro_gemm")(
        DTYPES[a.dtype], bm, bn, bk, a.data_ptr(), b.data_ptr(),
        c.data_ptr(), m, n, k, stream_handle(a.device)), "gemm")
    gemm.launches += 1
    return c


def gemm_bias_act(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
                  fn: str = "",
                  tile: tuple[int, int, int] | None = None) -> torch.Tensor:
    """C = act(A @ B + bias) for A (M, K), B (K, N) of one dtype, f32 or
    bf16, and bias (N,) in f32 or that dtype; ``fn`` is one of "",
    "sigmoid", "tanh", "relu".  The sum, the bias and the activation are
    f32; the result is rounded to the input type once."""
    if fn not in ACTS:
        raise ValueError(f"gemm_bias_act activation {fn!r}: need one of "
                         f"{list(ACTS)}")
    bm, bn, bk = _check_operands("gemm_bias_act", a, b, tile)
    n = b.shape[1]
    if bias.shape != (n,) or bias.dtype not in (torch.float32, a.dtype) \
            or bias.device != a.device:
        raise ValueError(f"gemm_bias_act bias {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}: need ({n},) in "
                         f"float32 or {a.dtype} on {a.device}")
    if a.device.type == "cpu":
        return gemm_bias_act_ref(a, b, bias, fn)
    m, k = a.shape
    bias = bias.float().contiguous()
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    check(_kernel("repro_gemm_bias_act")(
        DTYPES[a.dtype], bm, bn, bk, ACTS[fn], a.data_ptr(), b.data_ptr(),
        bias.data_ptr(), c.data_ptr(), m, n, k, stream_handle(a.device)),
        "gemm_bias_act")
    gemm_bias_act.launches += 1
    return c


gemm.launches = 0
gemm_bias_act.launches = 0
