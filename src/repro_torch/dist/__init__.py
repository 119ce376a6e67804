"""repro_torch.dist — the placement layer.

The models stay mesh-agnostic: they call ``ctx.constrain(x, name)`` with a
small rule-name vocabulary (``residual``, ``heads``, ``ffn_hidden``,
``logits``, ``scores``, ``expert_*``) and the launch layer decides what
those names mean by entering ``ctx.activation_sharding_ctx(rules)``.
Outside the context every constraint is a transparent no-op.  The rules
that place a tensor on a device mesh (``sharding.py``, on DTensor) are not
ported yet.
"""
from . import ctx

__all__ = ["ctx"]
