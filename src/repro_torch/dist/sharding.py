"""Partition rules: pure ``PartitionSpec`` logic, no devices required.

The rules are the JAX package's, line for line.  A spec is this module's
``PartitionSpec`` (a tuple with one entry a dimension: an axis name, a
tuple of them, or None) and a placement its ``NamedSharding`` (a mesh and
a spec); on one card every placement the rules give has extent 1, and
``place`` puts a tensor on that card.  Placing a tensor over several
cards (DTensor) is not ported.

The production mesh is (data=16, model=16) per pod with an optional leading
``pod`` axis; ``dp_axes`` treats every axis except the tensor-parallel
``model`` axis as data-parallel.  All assignment is divisibility-aware:
an axis is only used when its mesh extent divides the tensor dimension,
otherwise the rule falls back (next candidate axis) or replicates — that is
what keeps one rule set valid across all ten architectures (28-head qwen2,
8-expert mixtral, 40-head qwen1.5, ...) without per-model spec tables.

Parameter placement follows the Megatron/GSPMD conventions:

* column-parallel (wq/wk/wv, w_gate/w_up, generic projections): FSDP over
  the data axes on the input dim, TP over ``model`` on the output dim;
* row-parallel (wo, w_down, w_out): TP on the input dim, FSDP on output;
* embed/lm_head: vocab on ``model``, d_model on data;
* MoE experts: expert-parallel over ``model`` when the expert count
  divides it, else TP inside each expert (mixtral's 8 experts on a 16-way
  axis);
* sLSTM recurrent weights (``r_*``): replicated — the sequential
  recurrence must run without per-step collectives;
* norms / biases / gates: replicated.

``tests/test_sharding.py`` is the executable spec for the JAX package's
rules; ``tests/test_torch_sharding.py`` holds these to them.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..models.convert import jax_items

#: the tensor-parallel mesh axis; everything else is data-parallel
MODEL_AXIS = "model"

#: leaf names whose last-but-one dim is contracted (input) by the matmul
_ROW_PARALLEL = {"wo", "w_down", "w_out"}

#: MoE expert-weight leaves (expert dim at shape[-3])
_EXPERT_LEAVES = {"w_gate", "w_up", "w_down"}


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dimension (an axis name,
    a tuple of names, or None); ``P()`` replicates every dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A placement: ``spec`` over the axes of ``mesh``."""
    mesh: object
    spec: PartitionSpec

    @property
    def extent(self) -> int:
        """The number of pieces the tensor is cut into: the product of the
        extents of the axes the spec names."""
        return math.prod(self.mesh.shape[a] for e in self.spec
                         for a in _axes_tuple(e))

    @property
    def device(self) -> torch.device:
        """The one device that holds the whole tensor."""
        devices = getattr(self.mesh, "devices", ())
        if len(devices) != 1:
            raise NotImplementedError(
                f"{self.spec} on a mesh of {len(devices)} devices: placing a "
                "tensor across cards (DTensor) is not ported; the trainer "
                "runs on one card")
        return devices[0]


def place(x, sharding) -> torch.Tensor:
    """``x`` (an array or a tensor) on the device of ``sharding`` (a
    ``NamedSharding`` on a one-device mesh, or a device)."""
    dev = getattr(sharding, "device", sharding)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(dev)


# --------------------------------------------------------------------------- #
# axis helpers
# --------------------------------------------------------------------------- #


def _axes_tuple(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in _axes_tuple(axes):
        n *= mesh.shape[a]
    return n


def _one(axes):
    """Collapse a single-axis tuple to its bare name (P('data') is not
    P(('data',)) under PartitionSpec equality)."""
    t = _axes_tuple(axes)
    if not t:
        return None
    return t[0] if len(t) == 1 else t


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes: every mesh axis except ``model``."""
    return tuple(n for n in mesh.axis_names if n != MODEL_AXIS)


def shard_dim(mesh, size: int, axes, fallback=None):
    """First of (``axes``, ``fallback``) whose combined mesh extent divides
    ``size``; None when neither does (replicate the dim)."""
    for cand in (axes, fallback):
        t = _axes_tuple(cand)
        if not t or any(a not in mesh.shape for a in t):
            continue
        if size % _axes_size(mesh, t) == 0:
            return cand
    return None


def _spec(entries) -> P:
    """PartitionSpec from per-dim entries; all-replicated collapses to P()."""
    if all(e is None for e in entries):
        return P()
    return P(*entries)


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #


def _is_vector_leaf(leaf: str) -> bool:
    return (leaf.startswith("norm") or leaf.startswith("b_")
            or leaf in {"bq", "bk", "bv", "conv_b", "dt_bias", "D_skip",
                        "scale"})


def param_spec(name: str, shape: tuple[int, ...], mesh, cfg) -> P:
    """Placement for one named parameter.

    ``name`` is the '/'-joined pytree path (e.g. ``layers/attn/wq``); any
    leading dims beyond the matmul's trailing (in, out) pair are stacked
    scan/layer dims and stay replicated.
    """
    leaf = name.split("/")[-1]
    ndim = len(shape)
    dp = dp_axes(mesh)
    entries = [None] * ndim

    if _is_vector_leaf(leaf) or ndim < 2:
        return P()

    # sLSTM recurrent weights: replicated so the time scan stays local
    if leaf.startswith("r_"):
        return P()

    if leaf == "embed":
        entries[-2] = _one(shard_dim(mesh, shape[-2], MODEL_AXIS))
        entries[-1] = _one(shard_dim(mesh, shape[-1], dp))
        return _spec(entries)

    # MoE expert weights: (..., E, in, out)
    if (leaf in _EXPERT_LEAVES and ndim >= 3 and getattr(cfg, "n_experts", 0)
            and shape[-3] == cfg.n_experts and "ffn" in name.split("/")):
        ep = shard_dim(mesh, cfg.n_experts, MODEL_AXIS)
        if ep is not None:              # expert-parallel over the model axis
            entries[-3] = _one(ep)
            entries[-2] = _one(shard_dim(mesh, shape[-2], dp))
            return _spec(entries)
        # TP fallback inside each expert (expert count doesn't divide)
        if leaf in _ROW_PARALLEL:
            entries[-2] = _one(shard_dim(mesh, shape[-2], MODEL_AXIS))
            entries[-1] = _one(shard_dim(mesh, shape[-1], dp))
        else:
            entries[-2] = _one(shard_dim(mesh, shape[-2], dp))
            entries[-1] = _one(shard_dim(mesh, shape[-1], MODEL_AXIS))
        return _spec(entries)

    if leaf in _ROW_PARALLEL:
        entries[-2] = _one(shard_dim(mesh, shape[-2], MODEL_AXIS))
        entries[-1] = _one(shard_dim(mesh, shape[-1], dp))
        return _spec(entries)

    # generic column-parallel projection (lm_head included)
    entries[-2] = _one(shard_dim(mesh, shape[-2], dp))
    entries[-1] = _one(shard_dim(mesh, shape[-1], MODEL_AXIS))
    return _spec(entries)


# --------------------------------------------------------------------------- #
# batches
# --------------------------------------------------------------------------- #


def _batch_entries(mesh, shape) -> list:
    """Per-dim entries with the batch dim (dim0, else dim1 when batch=1
    long-context doesn't divide) over the data axes."""
    dp = dp_axes(mesh)
    entries = [None] * len(shape)
    ax = shard_dim(mesh, shape[0], dp)
    if ax is not None:
        entries[0] = _one(ax)
    elif len(shape) >= 2:
        ax = shard_dim(mesh, shape[1], dp)
        if ax is not None:
            entries[1] = _one(ax)
    return entries


def batch_spec(name: str, shape: tuple[int, ...], mesh) -> P:
    """Inputs shard their batch dim over the data axes; when the batch
    doesn't divide (batch=1 long-context decode) the sequence dim takes the
    data axes instead."""
    del name  # one rule for every input kind today
    return P(*_batch_entries(mesh, shape))


# --------------------------------------------------------------------------- #
# serving caches / recurrent state
# --------------------------------------------------------------------------- #


def cache_spec(name: str, shape: tuple[int, ...], mesh, cfg) -> P:
    """Placement for decode-state leaves.

    * ``kv/{k,v}`` (..., B, S, KV, hd): batch over data; KV heads over
      ``model`` when they divide, else the head_dim takes ``model`` (GQA
      archs like qwen2.5's kv=8 on a 16-way axis);
    * mamba ``h``/``conv``: batch over data, d_inner over ``model``;
    * mLSTM/sLSTM recurrent state: batch over data, trailing feature dim
      over ``model`` when divisible.
    """
    parts = name.split("/")
    leaf = parts[-1]
    ndim = len(shape)
    dp = dp_axes(mesh)
    entries = [None] * ndim

    if "mlstm" in parts or "slstm" in parts:
        b = 2 if "mlstm" in parts else 1    # (nb[, nm], B, ...)
        if b < ndim:
            entries[b] = _one(shard_dim(mesh, shape[b], dp))
        if ndim > b + 1:
            entries[-1] = _one(shard_dim(mesh, shape[-1], MODEL_AXIS))
        return _spec(entries)

    if leaf in ("k", "v") and ndim >= 4:    # KV cache
        entries[ndim - 4] = _one(shard_dim(mesh, shape[ndim - 4], dp))
        heads = shard_dim(mesh, shape[-2], MODEL_AXIS)
        if heads is not None:
            entries[-2] = _one(heads)
        else:
            entries[-1] = _one(shard_dim(mesh, shape[-1], MODEL_AXIS))
        return _spec(entries)

    if leaf == "h" and ndim >= 3:           # mamba SSM state (..., B, di, ds)
        entries[ndim - 3] = _one(shard_dim(mesh, shape[ndim - 3], dp))
        entries[-2] = _one(shard_dim(mesh, shape[-2], MODEL_AXIS))
        return _spec(entries)

    if leaf == "conv" and ndim >= 3:        # conv tail (..., B, dc-1, di)
        entries[ndim - 3] = _one(shard_dim(mesh, shape[ndim - 3], dp))
        entries[-1] = _one(shard_dim(mesh, shape[-1], MODEL_AXIS))
        return _spec(entries)

    return P()                              # unknown state: replicate


# --------------------------------------------------------------------------- #
# activations
# --------------------------------------------------------------------------- #


def make_activation_rules(mesh, cfg):
    """Build the ``rules(name, shape) -> NamedSharding | None`` callable the
    models consume through ``ctx.constrain``.

    Unknown names return None (constrain no-ops), which is what keeps the
    rule vocabulary open — a model may constrain names the launch layer has
    no opinion about on this mesh.
    """
    dp = dp_axes(mesh)

    def _batchish(shape):
        return _batch_entries(mesh, shape)

    def _heads(shape):
        # (B, T, H, hd): heads over model; 28-head archs fall back to
        # sequence sharding over the model axis (sequence parallelism)
        entries = _batchish(shape)
        h = shard_dim(mesh, shape[2], MODEL_AXIS)
        if h is not None:
            entries[2] = _one(h)
        elif entries[1] is None:
            entries[1] = _one(shard_dim(mesh, shape[1], MODEL_AXIS))
        return entries

    def _last_model(shape):
        # (B, T, F|V|D): batch over data, trailing feature dim over model
        entries = _batchish(shape)
        entries[-1] = _one(shard_dim(mesh, shape[-1], MODEL_AXIS))
        return entries

    def _scores(shape):
        # (B, H, T, S): batch over data, heads over model.  The layout
        # differs from the (B, T, ...) rules — dim 1 is heads, so the
        # batch=1 long-context fallback shards the query-time dim instead.
        entries = [None] * len(shape)
        ax = shard_dim(mesh, shape[0], dp)
        if ax is not None:
            entries[0] = _one(ax)
        elif len(shape) >= 3:
            ax = shard_dim(mesh, shape[2], dp)
            if ax is not None:
                entries[2] = _one(ax)
        if len(shape) >= 2:
            entries[1] = _one(shard_dim(mesh, shape[1], MODEL_AXIS))
        return entries

    def _expert_tokens(shape):
        # (E, G, C, D): expert-parallel over model when E divides
        entries = [None] * len(shape)
        entries[0] = _one(shard_dim(mesh, shape[0], MODEL_AXIS))
        if len(shape) >= 2:
            entries[1] = _one(shard_dim(mesh, shape[1], dp))
        return entries

    def _expert_hidden(shape):
        # (E, G, C, F): EP on E, else TP on the expert-hidden dim
        entries = _expert_tokens(shape)
        if entries[0] is None:
            entries[-1] = _one(shard_dim(mesh, shape[-1], MODEL_AXIS))
        return entries

    builders = {
        "residual": _batchish,
        "tokens": _batchish,
        "heads": _heads,
        "scores": _scores,
        "ffn_hidden": _last_model,
        "logits": _last_model,
        "expert_tokens4": _expert_tokens,
        "expert_hidden4": _expert_hidden,
    }

    def rules(name: str, shape):
        shape = tuple(shape)
        if name.startswith("kv/"):
            spec = cache_spec(name, shape, mesh, cfg)
        elif name in builders:
            spec = _spec(builders[name](shape))
        else:
            return None
        return NamedSharding(mesh, spec)

    return rules


# --------------------------------------------------------------------------- #
# tree-level wrappers
# --------------------------------------------------------------------------- #


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _map_with_path(fn, tree: Mapping) -> dict:
    """``fn(path, leaf)`` over the leaves of the JAX tree of ``tree`` (a
    module, a mapping of the port's names, or nested mappings), as a nested
    dict keyed as the JAX tree; a stacked leaf's shape is the stack's."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    out: dict = {}
    for path, leaf in jax_items(tree):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = fn("/".join(path), leaf)
    return out


def param_shardings(tree, mesh, cfg):
    """NamedSharding tree mirroring the JAX parameter tree of ``tree``."""
    return _map_with_path(lambda p, leaf: NamedSharding(
        mesh, param_spec(p, tuple(leaf.shape), mesh, cfg)), tree)


def batch_shardings(tree, mesh):
    return _map_with_path(lambda p, leaf: NamedSharding(
        mesh, batch_spec(p, tuple(leaf.shape), mesh)), tree)


def cache_shardings(tree, mesh, cfg):
    return _map_with_path(lambda p, leaf: NamedSharding(
        mesh, cache_spec(p, tuple(leaf.shape), mesh, cfg)), tree)
