"""Carry the JAX package's parameters into the port's models.

The JAX ``init`` gives a pytree whose layer stacks are stacked on leading
axes: ``layers``, whisper's ``enc`` and ``dec``, xLSTM's ``blocks/slstm``
and Jamba's ``blocks/attn`` on one (a layer or macro-block each), xLSTM's
``blocks/mlstm`` and Jamba's ``blocks/dense`` and ``blocks/moe`` on two
(macro-block, then sublayer).  The port keeps one module per layer, so
``from_jax_params`` unstacks them and loads every leaf, unchanged, into the
parameter of the same name.
"""
from __future__ import annotations

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
