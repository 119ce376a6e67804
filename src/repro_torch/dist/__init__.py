"""repro_torch.dist — the placement layer.

The models stay mesh-agnostic: they call ``ctx.constrain(x, name)`` with a
small rule-name vocabulary (``residual``, ``heads``, ``ffn_hidden``,
``logits``, ``scores``, ``expert_*``) and the launch layer decides what
those names mean by entering ``ctx.activation_sharding_ctx(rules)``.
Outside the context every constraint is a transparent no-op.  The rules
(``sharding.py``) are the JAX package's, over the meshes of ``compat.py``;
on one card every placement they give has extent 1.  Placing a tensor
across cards (DTensor) is not ported.
"""
from . import ctx

__all__ = ["ctx"]
