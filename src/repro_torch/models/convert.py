"""Carry the JAX package's parameters into the port's models.

The JAX ``init`` gives a pytree whose layer stacks (``layers``, whisper's
``enc`` and ``dec``) are stacked on axis 0; the port keeps one module per
layer.  ``from_jax_params`` unstacks them and loads every leaf, unchanged,
into the parameter of the same name.
"""
from __future__ import annotations

import numpy as np
import torch

from .api import build_model
from .config import ModelConfig

#: subtrees of the JAX parameter tree stacked on axis 0, one entry a layer
STACKED = ("layers", "enc", "dec")


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 (2 bytes)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: dict, prefix: str, out: dict, index=None) -> None:
    for name, node in tree.items():
        if isinstance(node, dict):
            _flatten(node, f"{prefix}{name}.", out, index)
        else:
            out[prefix + name] = node if index is None else np.asarray(
                node)[index]


def state_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX tree (numpy leaves) as the port's ``state_dict`` names:
    ``layers.<i>.attn.wq`` for leaf i of ``layers/attn/wq``."""
    flat: dict = {}
    for name, node in tree.items():
        if name in STACKED:
            n = len(next(iter(_leaves(node))))
            for i in range(n):
                _flatten(node, f"{name}.{i}.", flat, index=i)
        elif isinstance(node, dict):
            _flatten(node, f"{name}.", flat)
        else:
            flat[name] = node
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
