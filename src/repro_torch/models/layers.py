"""Shared layer substrate: norms, rotary embedding, initializers, losses.

Weights keep JAX's ``[fan_in, fan_out]`` layout, so a projection is
``x @ w`` with no transpose.  Every parameter lives in a ``TreeModule``,
whose ``tree()`` gives the nested dict of tensors the functions of this
package read, under the names of the JAX package's parameter tree.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard


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
    the MoE router too, as the JAX package's layer cast does.  A DTensor
    leaf is then ``gathered``."""
    return {k: cast_tree(v, pdtype, dtype) if isinstance(v, dict)
            else gathered(v.to(dtype) if v.dtype == pdtype else v)
            for k, v in tree.items()}


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as a layer reads it.  A DTensor (a trainer on a
    ``DistMesh``) is gathered on every mesh axis but ``model``, as FSDP
    gathers a weight before use (its gradient is reduced and cut back on
    the way out), so a layer's products cut the batch over the data axes
    and the weights over ``model`` alone, as JAX's partitioner runs them.
    Left to itself, DTensor picks each product's placements for the fewest
    bytes moved, and where the activations are smaller than the weight (a
    decode step) repeats the product on every rank of ``model``."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    return w.redistribute(w.device_mesh, [
        p if name == "model" else Replicate()
        for name, p in zip(names, w.placements)])


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``.  A DTensor table (a trainer on a
    ``DistMesh``) is gathered whole first, as FSDP gathers a weight before
    use, and the rows come out cut as the ids are: DTensor's own rule for a
    vocabulary cut (a masked partial sum) fails when the ids are cut over a
    mesh dimension that also cuts the table's columns, and in the backward
    when the gradient arrives as a plain partial sum."""
    if isinstance(table, DTensor):
        table = table.redistribute(table.device_mesh,
                                   [Replicate()] * table.device_mesh.ndim)
    return F.embedding(tokens, table)


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``.  A DTensor (a trainer on a ``DistMesh``) is
    first gathered on the dimensions whose cut the reshape cannot carry,
    and so is its gradient on the way back: DTensor's view rule keeps a
    cut only where a dimension is split with the cut on its first factor,
    which the cut divides, or where dimensions are merged with the cut on
    the first of them alone.  JAX's partitioner reshards the others, as
    this does (the heads of qwen2-7b, 28, on a 16-way model axis)."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    new = list(shape)
    if -1 in new:
        i = new.index(-1)
        new[i] = math.prod(x.shape) // math.prod(d for d in new if d != -1)
    return _Reshape.apply(x, tuple(new))


class _Reshape(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _carried(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, grad):
        return _carried(grad, ctx.shape).reshape(ctx.shape), None


def _carried(x, shape: tuple):
    """``x`` with every cut that a reshape to ``shape`` cannot carry
    gathered."""
    old = tuple(x.shape)
    cuts: dict = {}
    for p, n in zip(x.placements, x.device_mesh.shape):
        if isinstance(p, Shard):
            cuts[p.dim] = cuts.get(p.dim, 1) * n
    bad = set()
    for olds, news in _reshape_groups(old, shape):
        cut = [d for d in olds if d in cuts]
        if not cut or (len(olds) == 1 and len(news) == 1):
            continue
        if len(olds) == 1 and shape[news[0]] % cuts[olds[0]] == 0:
            continue                        # split, cut on the first factor
        if len(news) == 1:                  # merge: keep the first's cut
            bad.update(d for d in cut if d != olds[0])
            continue
        bad.update(cut)
    if not bad:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim in bad else p
        for p in x.placements])


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K) and w (K, N).  A DTensor ``x`` has its
    leading dimensions merged by ``reshape`` first: torch's matmul merges
    them with a view, which DTensor (torch 2.11) refuses when a dimension
    after the first of them is cut (the positions of qwen2-7b's heads
    fallback)."""
    if not isinstance(x, DTensor) or x.ndim <= 2:
        return x @ w
    lead = tuple(x.shape[:-1])
    return reshape(reshape(x, -1, x.shape[-1]) @ w, *lead, w.shape[-1])


def _reshape_groups(old: tuple, new: tuple):
    """(old dims, new dims) groups of equal products that a reshape maps
    onto each other; dimensions of size 1 join the group before them."""
    groups, i, j = [], 0, 0
    while i < len(old) or j < len(new):
        gi, gj = [], []
        po = pn = 1
        while True:
            if po <= pn and i < len(old):
                po *= old[i]
                gi.append(i)
                i += 1
            elif j < len(new):
                pn *= new[j]
                gj.append(j)
                j += 1
            else:
                break
            if po == pn and (i == len(old) or old[i] != 1) \
                    and (j == len(new) or new[j] != 1):
                break
        groups.append((gi, gj))
    return groups


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
    return (lse - _gold(logits, labels[..., None].long())).mean()


def _gold(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The logit of each label.  On a DTensor (a trainer on a ``DistMesh``)
    by a one-hot selection, which is exact (one term a row is not zero):
    DTensor's rule for ``gather`` along a cut vocabulary fails (its mask
    assumes two dimensions)."""
    if isinstance(logits, DTensor):
        vocab = torch.arange(logits.shape[-1], device=idx.device)
        return torch.where(idx == vocab, logits, 0.0).sum(-1)
    return torch.gather(logits, -1, idx)[..., 0]
