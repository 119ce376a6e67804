"""Plain PyTorch versions of every kernel in this package.

They compute in f32 and cast back to the input type, as the JAX package's
oracles do.  The CPU path of each kernel wrapper runs them, and the smoke
run holds each CUDA kernel against them on the card.

A float32 matrix product on the card must be IEEE f32, not TF32, for the
1e-5 parity tolerance, so importing this module sets
``torch.backends.cuda.matmul.allow_tf32 = False``.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


ACTIVATIONS = {"": lambda x: x, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
               "relu": torch.relu}


def gemm_bias_act_ref(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
                      fn: str = "") -> torch.Tensor:
    """act(A @ B + bias): product, bias and activation in f32, one cast to
    the input type at the end."""
    return ACTIVATIONS[fn](a.float() @ b.float() + bias.float()).to(a.dtype)


def k_slices(k: int, bk: int, split: int) -> list[tuple[int, int]]:
    """The K ranges [kb, ke) of a split-K launch: slice z covers the depth-bk
    steps [z * steps // split, (z + 1) * steps // split) of the ceil(k / bk)
    steps (``csrc/gemm.cu::k_slice``)."""
    steps = -(-k // bk)
    return [(z * steps // split * bk, min(k, (z + 1) * steps // split * bk))
            for z in range(split)]


def gemm_bias_act_split_ref(a: torch.Tensor, b: torch.Tensor,
                            bias: torch.Tensor | None, fn: str, bk: int,
                            split: int) -> torch.Tensor:
    """K1/K2 as a split-K launch computes them: the f32 products of the K
    slices, summed in slice order, then the bias (``None``: K1), the
    activation and one rounding to the input type."""
    a32, b32 = a.float(), b.float()
    acc = torch.zeros((a.shape[0], b.shape[1]), device=a.device)
    for kb, ke in k_slices(a.shape[1], bk, split):
        acc = acc + a32[:, kb:ke] @ b32[kb:ke]
    if bias is not None:
        acc = acc + bias.float()
    return ACTIVATIONS[fn](acc).to(a.dtype)


def gru_cell_ref(x: torch.Tensor, h: torch.Tensor, params: dict
                 ) -> torch.Tensor:
    """r/z/n-gate GRU step (same convention as core.kernels_ir.gru_cell)."""
    dtype = x.dtype
    x, h = x.float(), h.float()
    p = {k: v.float() for k, v in params.items()}
    r = torch.sigmoid(x @ p["Wr"] + h @ p["Ur"] + p["br"])
    z = torch.sigmoid(x @ p["Wz"] + h @ p["Uz"] + p["bz"])
    n = torch.tanh(x @ p["Wn"] + r * (h @ p["Un"] + p["bnh"]) + p["bnx"])
    return ((1 - z) * n + z * h).to(dtype)


def gru_seq_ref(xs: torch.Tensor, h0: torch.Tensor, params: dict
                ) -> torch.Tensor:
    """GRU over a [T, B, E] sequence; returns the final hidden state."""
    h = h0
    for x in xs:
        h = gru_cell_ref(x, h, params)
    return h
