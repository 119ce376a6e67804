"""Context-scoped activation placement.

``constrain(x, name)`` is the only placement hook the models use.  Inside
an ``activation_sharding_ctx(rules)`` block it asks the active rules for
the placement of ``name``; outside any context — unit tests, single-device
serving, kernels reused standalone — it is a transparent no-op, so model
code never imports a mesh.

The active rules live in a ``contextvars.ContextVar``, so a nested context
shadows the outer one and threads see their own rules.  The rules
(``dist.sharding.make_activation_rules``) return a placement for every name
they know.  On one card each has extent 1: it places the whole tensor, which
is where it is, so ``constrain`` returns it.  A placement over more than
one device (DTensor ``redistribute`` across cards) is not ported and
raises.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Callable, Optional

import torch

_RULES: ContextVar[Optional[Callable]] = ContextVar(
    "activation_sharding_rules", default=None)


@contextlib.contextmanager
def activation_sharding_ctx(rules: Callable):
    """Activate ``rules(name, shape) -> placement | None`` for the block.

    Nestable: an inner context shadows the outer one and the outer rules
    are restored on exit.
    """
    token = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(token)


def current_rules() -> Optional[Callable]:
    """The active rule set, or None when no context is entered."""
    return _RULES.get()


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """Constrain ``x`` to the active placement for ``name``.

    Identity when no ``activation_sharding_ctx`` is active, when the
    active rules have no opinion about ``name`` (they return None) — so an
    unknown rule name is never an error, just an unconstrained tensor — and
    when the placement's named axes all have extent 1 on its mesh.
    """
    rules = _RULES.get()
    if rules is None:
        return x
    placement = rules(name, tuple(x.shape))
    if placement is None or getattr(placement, "extent", None) == 1:
        return x
    raise NotImplementedError(
        f"constrain({name!r}): {placement!r} cuts the tensor over "
        f"{getattr(placement, 'extent', '?')} devices; placing an activation "
        "across cards (DTensor) waits for the multi-card slice")
