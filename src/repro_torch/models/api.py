"""Uniform model API: ``build_model(cfg, device)`` returns an ``nn.Module``
exposing

    init(generator) -> the model, its parameters drawn
    logits(batch) -> (B, T, V)
    loss(batch) -> scalar
    init_cache(batch, seq_len) -> cache dict
    prefill(batch, max_len) -> (cache, last_logits)
    decode_step(cache, tokens, pos) -> (logits, cache)

The parameters live on the model, on its device; the JAX package's
``params`` argument has no counterpart.
"""
from __future__ import annotations

from .config import ModelConfig
from .hybrid import HybridLM
from .transformer import DecoderLM
from .whisper import WhisperModel
from .xlstm_lm import XLSTMLM


def build_model(cfg: ModelConfig, device=None):
    """The model of ``cfg`` on ``device`` (the card when None; raises when
    there is none), its parameters allocated but not drawn: call
    ``init``.  ``device="meta"`` allocates nothing."""
    if cfg.family == "audio":
        return WhisperModel(cfg, device)
    if cfg.family == "ssm":
        return XLSTMLM(cfg, device)
    if cfg.family == "hybrid":
        return HybridLM(cfg, device)
    return DecoderLM(cfg, device)   # dense | moe | vlm
