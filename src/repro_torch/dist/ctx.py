"""Context-scoped activation placement.

``constrain(x, name)`` is the only placement hook the models use.  Inside
an ``activation_sharding_ctx(rules)`` block it asks the active rules for
the placement of ``name``; outside any context — unit tests, single-device
serving, kernels reused standalone — it is a transparent no-op, so model
code never imports a mesh.

The active rules live in a ``contextvars.ContextVar``, so a nested context
shadows the outer one and threads see their own rules.  The rules
(``dist.sharding.make_activation_rules``) return a placement for every name
they know.  On a ``DistMesh`` (a ``DeviceMesh``) ``constrain`` redistributes
the tensor to that placement, as JAX's ``with_sharding_constraint`` does: a
DTensor moves to the rule's placements; a plain tensor, a value every rank
holds whole (a table built inside the model), is taken as replicated first.
On a mesh of one device every placement has extent 1 and the tensor stays
where it is.  A mesh without devices (the abstract production meshes)
places nothing, and a placement of extent above 1 on it raises.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

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

    Identity when no ``activation_sharding_ctx`` is active and when the
    active rules have no opinion about ``name`` (they return None) — so an
    unknown rule name is never an error, just an unconstrained tensor.  On
    a ``DistMesh`` the result is ``x`` redistributed to the placement; on a
    mesh of devices, where every placement has extent 1, it is ``x``.
    """
    rules = _RULES.get()
    if rules is None:
        return x
    placement = rules(name, tuple(x.shape))
    if placement is None:
        return x
    mesh = getattr(placement, "mesh", None)
    dm = getattr(mesh, "device_mesh", None)
    if dm is not None:
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                                   run_check=False)
        return _Constrain.apply(x, tuple(placement.placements))
    if getattr(placement, "extent", None) == 1:
        return x
    raise ValueError(
        f"constrain({name!r}): {placement!r} cuts the tensor over "
        f"{getattr(placement, 'extent', '?')} pieces of a mesh without "
        "devices; place it on a DistMesh (dist.compat.device_mesh)")


class _Constrain(torch.autograd.Function):
    """``redistribute`` to ``placements`` whose backward places the
    gradient on the same ``placements``, as the transpose of JAX's
    ``with_sharding_constraint`` constrains the cotangent.  DTensor's own
    ``redistribute`` sends the gradient back to the input's placements, and
    its backward products, which pick the placements that move the fewest
    bytes, then repeat work on every rank of an axis (the attention output
    projection's gradients on every rank of ``model``)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None
