"""Mixture-of-Experts FFN with capacity-based dispatch.

Top-k routing materialises a (tokens, experts, capacity) dispatch tensor so
expert compute is two dense einsums over an (E, C, D) layout, exactly as the
JAX package dispatches: the same groups, the same capacity, the same queue
order, and the same tokens dropped past capacity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.ctx import constrain
from .config import ModelConfig
from .layers import TreeModule, init_dense_, param, reshape, silu


class MoE(TreeModule):
    """router [D, E] (always f32), w_gate and w_up [E, D, F], w_down
    [E, F, D]."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = param((D, E), torch.float32, device)
        self.w_gate = param((E, D, Fd), dtype, device)
        self.w_up = param((E, D, Fd), dtype, device)
        self.w_down = param((E, Fd, D), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        """One draw per weight, repeated in every expert (as the JAX init):
        at init all experts are the same."""
        for w in (self.router, self.w_gate, self.w_up, self.w_down):
            init_dense_(w, generator)


MOE_GROUP = 4096  # tokens per dispatch group (keeps dispatch linear in N)


def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, the lower index first on a tie
    (``lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D) through top-k experts with capacity.

    Dispatch is group-wise: tokens are split into groups of at most
    MOE_GROUP and each group gets its own capacity slice, so the one-hot
    tensors stay (G, n, E, c) with n, c fixed.  Router logits are f32
    against the router as given (bf16-rounded inside the layer stack); the
    one-hots and ``combine`` are in the activation dtype."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * T
    xf = reshape(x, N, D)

    n = min(MOE_GROUP, N)
    while N % n:
        n -= 1
    G = N // n
    xg = reshape(xf, G, n, D)

    logits = xg.float() @ p["router"].float()                    # (G, n, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                        # (G, n, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    C = max(1, int(cfg.capacity_factor * n * K / E))
    # position of each (token, k) within its expert queue, per group
    onehot = F.one_hot(gate_idx, E)                              # (G, n, K, E)
    flat = reshape(onehot, G, n * K, E)
    pos = torch.cumsum(flat, dim=1) - flat                       # (G, n*K, E)
    pos = reshape((pos * flat).sum(-1), G, n, K)
    keep = pos < C

    exp_oh = onehot.to(xf.dtype)                                 # (G, n, K, E)
    slot_oh = F.one_hot(torch.where(keep, pos, C), C + 1
                        ).to(xf.dtype)[..., :C]                  # (G, n, K, C)
    disp = torch.einsum("gnke,gnkc->gnec", exp_oh, slot_oh)
    combine = torch.einsum("gnk,gnke,gnkc->gnec",
                           gate_vals.to(xf.dtype), exp_oh, slot_oh)

    xe = constrain(torch.einsum("gnd,gnec->egcd", xg, disp), "expert_tokens4")
    g = silu(torch.einsum("egcd,edf->egcf", xe, p["w_gate"]))
    u = torch.einsum("egcd,edf->egcf", xe, p["w_up"])
    h = constrain(g * u, "expert_hidden4")
    ye = constrain(torch.einsum("egcf,efd->egcd", h, p["w_down"]),
                   "expert_tokens4")                             # (E, G, c, D)
    y = torch.einsum("gnec,egcd->gnd", combine, ye)
    return reshape(y, B, T, D)


def moe_aux_loss(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style)."""
    B, T, D = x.shape
    logits = reshape(x, -1, D).float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = torch.mean(
        F.one_hot(torch.argmax(probs, -1), cfg.n_experts).float(), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)
