"""Step builders shared by the trainer and the server (and, once ported,
the dry run).  The parameters live on the model that each builder returns,
and the optimizer state beside it, so a step takes the batch (and the
cache), not a parameter tree, and updates them in place.
"""
from __future__ import annotations

import torch

from ..models import build_model
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, apply_updates, init_opt_state


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    grad_accum: int = 1, device=None):
    """(model, opt_state, train_step(batch) -> metrics): the model of
    ``cfg`` on ``device`` (the card when None; its parameters allocated, not
    drawn), zero AdamW moments, and one step of the loss's gradient and
    AdamW in place.  With ``grad_accum > 1`` the batch is split into
    ``grad_accum`` micro-batches whose losses and f32 gradients are summed
    and divided by ``grad_accum``.  Metrics: ``loss``, ``grad_norm``,
    ``lr`` (0-d tensors on the device)."""
    model = build_model(cfg, device)
    opt_cfg = opt_cfg or AdamWConfig()
    params = dict(model.named_parameters())
    opt_state = init_opt_state(params)
    names = list(params)

    def value_and_grad(batch):
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), dict(zip(names, grads))

    def train_step(batch):
        if grad_accum > 1:
            loss = torch.zeros((), device=model.device)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            mbs = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                + tuple(v.shape[1:]))
                   for k, v in batch.items()}
            for i in range(grad_accum):
                mb_loss, mb_grads = value_and_grad(
                    {k: v[i] for k, v in mbs.items()})
                loss = loss + mb_loss
                for n, g in mb_grads.items():
                    grads[n] = grads[n] + g
            loss = loss / grad_accum
            grads = {n: g / grad_accum for n, g in grads.items()}
        else:
            loss, grads = value_and_grad(batch)
        _, _, metrics = apply_updates(params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return metrics

    return model, opt_state, train_step


def make_prefill_step(cfg: ModelConfig, max_len: int = 0, device=None):
    """(model, batch -> (cache, last_logits))."""
    model = build_model(cfg, device)

    def prefill_step(batch):
        return model.prefill(batch, max_len=max_len)

    return model, prefill_step


def make_serve_step(cfg: ModelConfig, device=None):
    """One decode step: (model, (cache, tokens, pos) -> (next_token_logits,
    cache)), one new token against the cache."""
    model = build_model(cfg, device)

    def serve_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)

    return model, serve_step


def eval_shape_params(cfg: ModelConfig):
    """Parameter shapes without allocating anything: the model on the
    ``meta`` device and its ``state_dict``."""
    model = build_model(cfg, device="meta")
    return model, model.state_dict()


def eval_shape_cache(cfg: ModelConfig, batch: int, seq_len: int):
    """The cache's shapes and dtypes, as ``meta`` tensors."""
    return build_model(cfg, device="meta").init_cache(batch, seq_len)
