"""Step builders shared by the trainer, the server and the dry run.  The
parameters live on the model that each builder returns, and the optimizer
state beside it, so a step takes the batch (and the cache), not a parameter
tree, and updates them in place.

Given a ``DistMesh`` (``dist.compat.device_mesh``), a builder places the
model's parameters by ``dist.sharding.param_shardings`` as DTensors, and
the AdamW moments beside them, the step counter replicated.  A model built
on the ``meta`` device is placed as fake tensors, which needs an active
``FakeTensorMode``: that is how the dry run gets the shapes of every rank's
pieces without allocating them (``eval_shape_*``).
"""
from __future__ import annotations

import torch

from ..dist.sharding import (cache_shardings, layer_shardings,
                             param_shardings, place_module, place_tree)
from ..models import build_model
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, OptState, apply_updates, init_opt_state


def _placed_model(cfg: ModelConfig, device, mesh):
    """The model of ``cfg`` on ``device``, its parameters placed on
    ``mesh`` by the rules when ``mesh`` is given."""
    model = build_model(cfg, device)
    if mesh is not None:
        place_module(model, layer_shardings(
            model, param_shardings(model, mesh, cfg)))
    return model


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    grad_accum: int = 1, device=None, mesh=None):
    """(model, opt_state, train_step(batch) -> metrics): the model of
    ``cfg`` on ``device`` (the card when None; its parameters allocated, not
    drawn), zero AdamW moments, and one step of the loss's gradient and
    AdamW in place.  With ``grad_accum > 1`` the batch is split into
    ``grad_accum`` micro-batches whose losses and f32 gradients are summed
    and divided by ``grad_accum``.  Metrics: ``loss``, ``grad_norm``,
    ``lr`` (0-d tensors on the device; DTensors on a ``mesh``)."""
    model = _placed_model(cfg, device, mesh)
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


def make_prefill_step(cfg: ModelConfig, max_len: int = 0, device=None,
                      mesh=None):
    """(model, batch -> (cache, last_logits))."""
    model = _placed_model(cfg, device, mesh)

    def prefill_step(batch):
        return model.prefill(batch, max_len=max_len)

    return model, prefill_step


def make_serve_step(cfg: ModelConfig, device=None, mesh=None):
    """One decode step: (model, (cache, tokens, pos) -> (next_token_logits,
    cache)), one new token against the cache."""
    model = _placed_model(cfg, device, mesh)

    def serve_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)

    return model, serve_step


def eval_shape_params(cfg: ModelConfig, mesh=None):
    """Parameter shapes without allocating anything: the model on the
    ``meta`` device and its ``state_dict``; with a ``DistMesh``, inside a
    ``FakeTensorMode``, its parameters fake DTensors placed by the rules."""
    model = _placed_model(cfg, "meta", mesh)
    return model, model.state_dict()


def eval_shape_opt_state(params_shape: dict) -> OptState:
    """The AdamW state of ``params_shape`` (name -> tensor, as
    ``eval_shape_params`` gives it): f32 moments placed as the parameters,
    the step counter replicated on their mesh."""
    return init_opt_state(params_shape)


def eval_shape_cache(cfg: ModelConfig, batch: int, seq_len: int, mesh=None):
    """The cache's shapes and dtypes, as ``meta`` tensors; with a
    ``DistMesh``, inside a ``FakeTensorMode``, fake DTensors placed by the
    rules."""
    cache = build_model(cfg, device="meta").init_cache(batch, seq_len)
    if mesh is None:
        return cache
    return place_tree(cache, layer_shardings(
        cache, cache_shardings(cache, mesh, cfg)))
