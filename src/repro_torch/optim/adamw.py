"""AdamW with global-norm clipping and a cosine schedule: the JAX
package's formula, step for step, applied in place.

``torch.optim.AdamW`` is not used: its decoupled decay and its ``eps``
placement round differently, and it has no global clip.  The parameters and
the moments are flat dicts keyed by the model's ``state_dict`` names (one
tensor a layer), which the JAX package holds as stacked leaves.  Two rules
read the JAX tree and not the port's: a leaf is decayed when the JAX leaf
that holds it has rank >= 2, its per-layer rank plus the stacked axes
(``models.convert.jax_rank``: every per-layer norm scale and bias is
decayed, ``norm_f`` is not), and the global norm sums the squares leaf by
JAX leaf, in JAX's leaf order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..models.convert import Stacked, jax_items, jax_rank


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor      # () int32, on the parameters' device
    mu: dict                # name -> f32 tensor
    nu: dict


def init_opt_state(params: dict) -> OptState:
    """Zero moments in f32 beside each parameter (a dict name -> tensor)."""
    dev = next(iter(params.values())).device
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros, nu={n: z.clone() for n, z in zeros.items()})


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay to ``min_lr_frac``, in f32."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares in f32, summed per JAX leaf (a stacked
    leaf's layers together) and over the leaves in JAX's order."""
    sq = 0
    for _, leaf in jax_items(tree):
        parts = leaf.members.values() if isinstance(leaf, Stacked) \
            else (leaf,)
        sq = sq + sum(torch.sum(torch.square(g.float())) for g in parts)
    return torch.sqrt(sq)


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: OptState,
                  cfg: AdamWConfig) -> tuple[dict, OptState, dict]:
    """One AdamW step in place on ``params`` (name -> tensor; the model's
    parameters) and the moments of ``state``, from ``grads`` (name ->
    tensor, left as they are); returns (params, state, metrics), the first
    two the objects passed in."""
    names = list(params)
    step = state.step.add_(1)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - cfg.beta1 ** stepf
    b2c = 1 - cfg.beta2 ** stepf

    ps = [params[n] for n in names]
    p32 = [p if p.dtype == torch.float32 else p.float() for p in ps]
    mu = [state.mu[n] for n in names]
    nu = [state.nu[n] for n in names]
    g = torch._foreach_mul([grads[n].float() for n in names], scale)
    torch._foreach_mul_(mu, cfg.beta1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - cfg.beta1))
    torch._foreach_mul_(nu, cfg.beta2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(g, 1 - cfg.beta2), g))
    del g
    delta = torch._foreach_div(mu, b1c)                  # mhat
    den = torch._foreach_div(nu, b2c)                    # nhat
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(delta, den)
    del den
    decay = [i for i, n in enumerate(names) if jax_rank(n, ps[i]) >= 2]
    if decay:   # decay matrices only (standard practice), on JAX's ranks
        torch._foreach_add_([delta[i] for i in decay], torch._foreach_mul(
            [p32[i] for i in decay], cfg.weight_decay))
    torch._foreach_sub_(p32, torch._foreach_mul(delta, lr))
    for p, q in zip(ps, p32):
        if q is not p:
            p.copy_(q)
    return params, state, {"grad_norm": gnorm, "lr": lr}
