"""Step builders shared by the server (and, once ported, the trainer and
the dry run).  The parameters live on the model that each builder returns,
so a step takes the batch (and the cache), not a parameter tree.

``make_train_step`` comes with the port of the training driver (ROADMAP
Queue 1 item 3).
"""
from __future__ import annotations

from ..models import build_model
from ..models.config import ModelConfig


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
