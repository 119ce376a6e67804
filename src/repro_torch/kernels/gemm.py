"""K1: the blocked GEMM, C = A @ B — the matmul instruction ISAM maps onto.

``gemm`` launches the hand-written CUDA kernel in ``csrc/gemm.cu`` on a
CUDA tensor and runs the plain version (``ref.gemm_ref``) on a CPU tensor.
``tile=(BM, BN, BK)`` is one block's tile: normally chosen by
``ops.launch_config`` from the compiler's lowering (see
``ops.scheduled_gemm``).  f32 and bf16 inputs accumulate in f32 and the
result is returned in the input type.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .cuda import check, library, stream_handle
from .ref import gemm_ref

#: tile dims the CUDA library is built for
TILE_MN = (16, 32, 64, 128)
TILE_K = (16, 32)
THREADS = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DEFAULT_TILE = (64, 64, 32)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = library("gemm").repro_gemm
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_tile(tile) -> tuple[int, int, int]:
    bm, bn, bk = (int(t) for t in tile)
    if bm not in TILE_MN or bn not in TILE_MN or bk not in TILE_K:
        raise ValueError(f"gemm tile {tuple(tile)} not built: BM, BN in "
                         f"{TILE_MN}, BK in {TILE_K}")
    return bm, bn, bk


def gemm(a: torch.Tensor, b: torch.Tensor,
         tile: tuple[int, int, int] = DEFAULT_TILE) -> torch.Tensor:
    """C = A @ B for A (M, K) and B (K, N) of one dtype, f32 or bf16."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError(f"gemm dtypes {a.dtype}, {b.dtype}: need one of "
                        f"{list(DTYPES)}")
    if a.device != b.device:
        raise ValueError(f"gemm operands on {a.device} and {b.device}")
    bm, bn, bk = _check_tile(tile)
    if a.device.type == "cpu":
        return gemm_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"gemm runs on cuda or cpu, not {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm needs contiguous operands")
    m, k = a.shape
    n = b.shape[1]
    if min(m, n, k) == 0:
        raise ValueError(f"gemm with an empty dimension: {m}x{n}x{k}")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    check(_kernel()(DTYPES[a.dtype], bm, bn, bk, a.data_ptr(), b.data_ptr(),
                    c.data_ptr(), m, n, k, stream_handle(a.device)), "gemm")
    gemm.launches += 1
    return c


gemm.launches = 0
