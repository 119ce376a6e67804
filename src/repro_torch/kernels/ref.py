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


def gru_update(ar, az, anx, anh, h, params: dict) -> torch.Tensor:
    """The gate epilogue on the four f32 sums x Wr + h Ur, x Wz + h Uz,
    x Wn and h Un (without biases) of a step from state ``h``."""
    p = {k: params[k].float() for k in ("br", "bz", "bnx", "bnh")}
    r = torch.sigmoid(ar + p["br"])
    z = torch.sigmoid(az + p["bz"])
    n = torch.tanh(anx + r * (anh + p["bnh"]) + p["bnx"])
    return (1 - z) * n + z * h


def gru_cell_ref(x: torch.Tensor, h: torch.Tensor, params: dict
                 ) -> torch.Tensor:
    """r/z/n-gate GRU step (same convention as core.kernels_ir.gru_cell)."""
    dtype = x.dtype
    x, h = x.float(), h.float()
    p = {k: v.float() for k, v in params.items()}
    return gru_update(x @ p["Wr"] + h @ p["Ur"], x @ p["Wz"] + h @ p["Uz"],
                      x @ p["Wn"], h @ p["Un"], h, p).to(dtype)


def gru_k_slices(e: int, h: int, kc: int, split: int
                 ) -> list[tuple[tuple[int, int], tuple[int, int]]]:
    """The reduction ranges of a split K3 step (``csrc/gru.cu``): the
    ceil(e / kc) chunks of x's rows, then the ceil(h / kc) chunks of h's,
    cut into ``split`` slices of whole chunks; slice z covers chunks
    [z * C // split, (z + 1) * C // split).  Each slice as ((xb, xe),
    (hb, he)), the rows of x and of h it reduces over."""
    cx, ch = -(-e // kc), -(-h // kc)
    out = []
    for z in range(split):
        cb, ce = z * (cx + ch) // split, (z + 1) * (cx + ch) // split
        out.append(((min(cb, cx) * kc, min(ce * kc, cx * kc, e)),
                    (max(cb - cx, 0) * kc, min(max(ce - cx, 0) * kc, h))))
    return out


def gru_cell_split_ref(x: torch.Tensor, h: torch.Tensor, params: dict,
                       kc: int, split: int) -> torch.Tensor:
    """K3 as a split launch computes it: each slice's four partial sums
    (``gru_k_slices``), added in slice order, then the bias and the gate
    epilogue."""
    dtype = x.dtype
    x, h = x.float(), h.float()
    p = {k: v.float() for k, v in params.items()}
    acc = [torch.zeros((x.shape[0], h.shape[1]), device=x.device)
           for _ in range(4)]
    for (xb, xe), (hb, he) in gru_k_slices(x.shape[1], h.shape[1], kc, split):
        xs, hs = x[:, xb:xe], h[:, hb:he]
        parts = (xs @ p["Wr"][xb:xe] + hs @ p["Ur"][hb:he],
                 xs @ p["Wz"][xb:xe] + hs @ p["Uz"][hb:he],
                 xs @ p["Wn"][xb:xe], hs @ p["Un"][hb:he])
        acc = [a + q for a, q in zip(acc, parts)]
    return gru_update(*acc, h, p).to(dtype)


def gru_seq_ref(xs: torch.Tensor, h0: torch.Tensor, params: dict
                ) -> torch.Tensor:
    """GRU over a [T, B, E] sequence; returns the final hidden state."""
    h = h0
    for x in xs:
        h = gru_cell_ref(x, h, params)
    return h


def gru_seq_hoisted_ref(xs: torch.Tensor, h0: torch.Tensor, params: dict
                        ) -> torch.Tensor:
    """K4 as the port computes it: G = xs [T B, E] @ [Wr|Wz|Wn] +
    [br|bz|bnx] from one product for all steps, then the recurrence on
    h [Ur|Uz|Un], with bnh inside r (..)."""
    dtype = xs.dtype
    T, B, E = xs.shape
    H = h0.shape[1]
    p = {k: v.float() for k, v in params.items()}
    w = torch.cat([p["Wr"], p["Wz"], p["Wn"]], 1)
    bias = torch.cat([p["br"], p["bz"], p["bnx"]])
    g = (xs.float().reshape(T * B, E) @ w + bias).view(T, B, 3 * H)
    u = torch.cat([p["Ur"], p["Uz"], p["Un"]], 1)
    h = h0.float()
    for t in range(T):
        hu = h @ u
        r = torch.sigmoid(g[t, :, :H] + hu[:, :H])
        z = torch.sigmoid(g[t, :, H:2 * H] + hu[:, H:2 * H])
        n = torch.tanh(g[t, :, 2 * H:] + r * (hu[:, 2 * H:] + p["bnh"]))
        h = (1 - z) * n + z * h
    return h.to(dtype)
