"""Carry the JAX package's parameters into the port's models.

The JAX ``init`` gives a pytree whose layer stacks are stacked on leading
axes: ``layers``, whisper's ``enc`` and ``dec``, xLSTM's ``blocks/slstm``
and Jamba's ``blocks/attn`` on one (a layer or macro-block each), xLSTM's
``blocks/mlstm`` and Jamba's ``blocks/dense`` and ``blocks/moe`` on two
(macro-block, then sublayer).  The port keeps one module per layer, so
``from_jax_params`` unstacks them and loads every leaf, unchanged, into the
parameter of the same name; ``jax_items`` is the inverse, the view of a
port tree (a ``state_dict``, or any mapping of the port's names) as the
JAX tree's leaves, its per-layer tensors grouped back into stacked leaves,
which the checkpoint, the optimizer's leaf order and the sharding rules
read.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch

from .api import build_model
from .config import ModelConfig

#: subtrees of the JAX parameter tree stacked on leading axes, by path,
#: and the number of those axes
STACKED = {"layers": 1, "enc": 1, "dec": 1, "blocks/slstm": 1,
           "blocks/attn": 1, "blocks/mlstm": 2, "blocks/dense": 2,
           "blocks/moe": 2}


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 (2 bytes)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: dict, path: str, out: dict) -> None:
    """The leaves under ``tree`` (at ``path``, "/"-separated) into ``out``
    under their dotted names; a stacked subtree as one entry a layer."""
    for name, node in tree.items():
        sub = f"{path}/{name}" if path else name
        axes = STACKED.get(sub)
        if axes:
            lead = np.shape(next(_leaves(node)))[:axes]
            for idx in np.ndindex(*lead):
                _flatten(_index(node, idx),
                         "/".join([sub, *map(str, idx)]), out)
        elif isinstance(node, dict):
            _flatten(node, sub, out)
        else:
            out[sub.replace("/", ".")] = node


def _index(tree: dict, idx: tuple) -> dict:
    return {k: _index(v, idx) if isinstance(v, dict) else np.asarray(v)[idx]
            for k, v in tree.items()}


def state_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX tree (numpy leaves) as the port's ``state_dict`` names:
    ``layers.<i>.attn.wq`` for leaf i of ``layers/attn/wq``,
    ``blocks.mlstm.<b>.<j>.p.wq`` for leaf (b, j) of
    ``blocks/mlstm/p/wq``."""
    flat: dict = {}
    _flatten(tree, "", flat)
    return {k: _tensor(v) for k, v in flat.items()}


def _leaves(tree: dict):
    for node in tree.values():
        if isinstance(node, dict):
            yield from _leaves(node)
        else:
            yield node


def from_jax_params(cfg: ModelConfig, tree: dict, device=None):
    """The port's model of ``cfg`` on ``device`` (the card when None) holding
    exactly the values of ``tree``, the JAX ``init``'s pytree with numpy
    leaves.  Every leaf must match its parameter's shape and dtype, and
    every parameter must have a leaf."""
    model = build_model(cfg, device)
    state = state_from_jax(tree)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"{cfg.name}: parameters without a leaf {missing}, "
                       f"leaves without a parameter {extra}")
    for name, t in state.items():
        if t.shape != own[name].shape or t.dtype != own[name].dtype:
            raise ValueError(
                f"{cfg.name}: {name} is {tuple(t.shape)} {t.dtype} in the "
                f"tree, {tuple(own[name].shape)} {own[name].dtype} in the "
                "model")
    model.load_state_dict(state, strict=True)
    return model


def jax_leaf_index(parts) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """A leaf's path in a port tree (a dotted ``state_dict`` name split on
    the dots, or the keys of nested mappings) as (the path of its JAX leaf,
    its index on that leaf's stacked axes): ``blocks.mlstm.0.1.p.wq`` is
    ((blocks, mlstm, p, wq), (0, 1)).  A stacked subtree given without
    indices (a JAX tree itself) keeps its path and the index ()."""
    rest, out, idx = [str(p) for p in parts], [], ()
    while rest:
        out.append(rest.pop(0))
        n = STACKED.get("/".join(out), 0)
        if n and len(rest) > n and all(r.isdigit() for r in rest[:n]):
            idx += tuple(int(r) for r in rest[:n])
            del rest[:n]
    return tuple(out), idx


class Stacked:
    """The port's tensors of one stacked JAX leaf, by index on the stacked
    axes (``lead`` their extents), as one array: ``shape`` and
    ``stack()``."""

    def __init__(self, members: dict):
        self.members = dict(sorted(members.items()))
        self.lead = tuple(max(i[a] for i in self.members) + 1
                          for a in range(len(next(iter(self.members)))))
        if len(self.members) != math.prod(self.lead):
            raise ValueError(f"stack {self.lead} has {len(self.members)} "
                             "members")
        first = next(iter(self.members.values()))
        self.shape = self.lead + tuple(first.shape)

    def stack(self) -> torch.Tensor:
        return torch.stack(list(self.members.values())).reshape(self.shape)


def copy_leaf_(t: torch.Tensor, value) -> None:
    """Fill ``t`` in place with ``value`` (an array or tensor of its exact
    shape, cast to its dtype)."""
    value = torch.as_tensor(np.asarray(value) if not isinstance(
        value, torch.Tensor) else value)
    if tuple(value.shape) != tuple(t.shape):
        raise ValueError(f"leaf of shape {tuple(value.shape)} for a tensor "
                         f"of shape {tuple(t.shape)}")
    with torch.no_grad():
        t.copy_(value)


def _flat_items(tree: Mapping, prefix: tuple = ()):
    for name, node in tree.items():
        parts = prefix + tuple(str(name).split("."))
        if isinstance(node, Mapping):
            yield from _flat_items(node, parts)
        else:
            yield parts, node


def jax_items(tree: Mapping) -> list[tuple[tuple[str, ...], object]]:
    """The leaves of ``tree`` (a ``state_dict``, a mapping of the port's
    names, or nested mappings) as the JAX tree's: (path, leaf) in JAX's
    leaf order (dict keys sorted at every level), a stacked leaf as one
    ``Stacked``."""
    groups: dict = {}
    for parts, node in _flat_items(tree):
        path, idx = jax_leaf_index(parts)
        groups.setdefault(path, {})[idx] = node
    return [(path, m[()] if list(m) == [()] else Stacked(m))
            for path, m in sorted(groups.items())]


def jax_rank(name: str, t: torch.Tensor) -> int:
    """The rank of the JAX leaf that holds ``t`` (the port's tensor named
    ``name``): its own rank plus the stacked axes in front of it."""
    return t.ndim + len(jax_leaf_index(name.split("."))[1])
