"""Shared layer substrate: norms, rotary embedding, initializers, losses.

Weights keep JAX's ``[fan_in, fan_out]`` layout, so a projection is
``x @ w`` with no transpose.  Every parameter lives in a ``TreeModule``,
whose ``tree()`` gives the nested dict of tensors the functions of this
package read, under the names of the JAX package's parameter tree.
"""
from __future__ import annotations

import torch
from torch import nn


def rmsnorm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def nonparam_ln(x, scale=None, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm: no scale, no bias (population
    variance, as ``jnp.var``)."""
    del scale
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm_fn(kind: str):
    return {"rmsnorm": rmsnorm, "nonparam_ln": nonparam_ln}[kind]


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter; ``init`` of the model fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def init_dense_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Fill ``w`` ([fan_in, fan_out], or [E, fan_in, fan_out]) with one
    Glorot-normal draw in f32, cast to ``w``'s dtype.  A stacked ``w``
    repeats the same draw in every slice, as the JAX init repeats one
    expert E times."""
    fan_in, fan_out = w.shape[-2:]
    scale = (2.0 / (fan_in + fan_out)) ** 0.5
    one = torch.randn((fan_in, fan_out), generator=generator,
                      device=w.device, dtype=torch.float32) * scale
    with torch.no_grad():
        w.copy_(one.to(w.dtype).expand_as(w))


def init_normal_(w: torch.Tensor, std: float,
                 generator: torch.Generator) -> None:
    with torch.no_grad():
        w.copy_((torch.randn(w.shape, generator=generator, device=w.device,
                             dtype=torch.float32) * std).to(w.dtype))


class TreeModule(nn.Module):
    """A module whose parameters and children mirror one subtree of the JAX
    parameter tree."""

    def tree(self) -> dict:
        out = dict(self.named_parameters(recurse=False))
        out.update((n, m.tree()) for n, m in self.named_children())
        return out


def cast_tree(tree: dict, pdtype: torch.dtype, dtype: torch.dtype) -> dict:
    """Every leaf stored in ``pdtype`` cast to ``dtype``; the rest as is.
    With f32 params and bf16 activations this rounds the norm scales and
    the MoE router too, as the JAX package's layer cast does."""
    return {k: cast_tree(v, pdtype, dtype) if isinstance(v, dict)
            else v.to(dtype) if v.dtype == pdtype else v
            for k, v in tree.items()}


def rotary(pos: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """cos/sin tables at integer positions ``pos`` (any shape), in f32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=pos.device) / half))
    ang = pos.float()[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: (..., T, H, hd); cos/sin: (T, hd/2) broadcast over batch/heads.
    Half-split pairs (not interleaved), computed in f32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[..., None, :], sin[..., None, :]   # (T, 1, half)
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it: x * 1 / (1 + exp(-x)), each step
    rounded to the input's dtype (a fused ``F.silu`` rounds once, and
    differs in bf16)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def divisor_chunk(T: int, chunk: int) -> int:
    """The largest chunk length <= ``chunk`` that divides T, as the JAX
    package's scans pick it (1 at a prime T above ``chunk``)."""
    c = min(chunk, T)
    while T % c:
        c -= 1
    return c


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``:
    max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Stable next-token cross entropy in f32; logits (B, T, V), labels
    (B, T)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()
