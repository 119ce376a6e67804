"""xLSTM language model: macro-blocks of (slstm_period - 1) mLSTM blocks
followed by one sLSTM block (the paper's xLSTM[7:1] layout).

Serving keeps an O(1) recurrent state and no KV cache: ``prefill`` runs
``decode_step`` over the prompt's positions, as the JAX package does.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.cuda import resolve_device
from .config import ModelConfig
from .layers import (TreeModule, cross_entropy_loss, embed_lookup, init_dense_,
                     init_normal_, norm_fn, param, rmsnorm)
from .transformer import CastMixin, norm_scale
from .xlstm import (MLSTMParams, SLSTMParams, init_mlstm_state,
                    init_slstm_state, mlstm_block, mlstm_decode_step,
                    slstm_block, slstm_decode_step)


class RecurrentLayer(TreeModule):
    """p (an mLSTM's or an sLSTM's parameters) and its pre-norm scale
    norm [D]."""

    def __init__(self, params: TreeModule, d_model: int, device):
        super().__init__()
        self.p = params
        self.norm = norm_scale(d_model, device)

    def init(self, generator: torch.Generator) -> None:
        self.p.init(generator)
        nn.init.ones_(self.norm)


class XLSTMLM(CastMixin, nn.Module):
    """Parameters, under the JAX tree's names: ``embed`` [V, D],
    ``blocks.mlstm.<b>.<j>`` (j < slstm_period - 1) and
    ``blocks.slstm.<b>`` (``RecurrentLayer``s) for each macro-block b,
    ``norm_f`` [D] (f32) and ``lm_head`` [D, V]."""

    STACKS = ("blocks.mlstm", "blocks.slstm")
    HEADS = ("lm_head",)

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.slstm_period < 2 or cfg.n_layers % cfg.slstm_period:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} must be a "
                             f"multiple of slstm_period {cfg.slstm_period} "
                             ">= 2")
        dev = resolve_device(device)
        self.cfg = cfg
        self.nb = cfg.n_layers // cfg.slstm_period
        self.nm = cfg.slstm_period - 1
        self.dtype = getattr(torch, cfg.dtype)
        self.pdtype = pd = getattr(torch, cfg.param_dtype)
        self.embed = param((cfg.vocab_size, cfg.d_model), pd, dev)
        D = cfg.d_model

        def layer(kind):
            return RecurrentLayer(kind(cfg, pd, dev), D, dev)

        self.blocks = nn.ModuleDict({
            "mlstm": nn.ModuleList(
                nn.ModuleList(layer(MLSTMParams) for _ in range(self.nm))
                for _ in range(self.nb)),
            "slstm": nn.ModuleList(layer(SLSTMParams)
                                   for _ in range(self.nb))})
        self.norm_f = norm_scale(cfg.d_model, dev)
        self.lm_head = param((cfg.d_model, cfg.vocab_size), pd, dev)

    def init(self, generator: torch.Generator | None = None) -> "XLSTMLM":
        """As ``DecoderLM.init``: every parameter drawn from ``generator``
        with the JAX init's distributions."""
        if self.device.type == "meta":
            return self
        gen = generator or torch.Generator(self.device).manual_seed(0)
        for layer in self.modules():
            if isinstance(layer, RecurrentLayer):
                layer.init(gen)
        init_normal_(self.embed, 0.02, gen)
        nn.init.ones_(self.norm_f)
        init_dense_(self.lm_head, gen)
        return self

    def _tokens(self, tokens) -> torch.Tensor:
        return embed_lookup(tokens, self.embed).to(self.dtype)

    def _head(self, x) -> torch.Tensor:
        return rmsnorm(x, self.norm_f) @ self._weight("lm_head")

    def logits(self, batch) -> torch.Tensor:
        cfg = self.cfg
        nf = norm_fn(cfg.norm)
        x = self._tokens(batch["tokens"])

        def block(h, mls, sp):
            for mp in mls:
                h = h + mlstm_block(mp["p"], nf(h, mp["norm"]), cfg)
            return h + slstm_block(sp["p"], nf(h, sp["norm"]), cfg)

        for mls, sp in zip(self._layers("blocks.mlstm"),
                           self._layers("blocks.slstm")):
            x = self._block(block, x, mls, sp)
        return self._head(x)

    def loss(self, batch) -> torch.Tensor:
        logits = self.logits(batch)
        return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:])

    # ---- serving: O(1) recurrent state, no KV cache -------------------------
    def init_cache(self, batch: int, seq_len: int) -> dict:
        """{"mlstm": {"C", "n", "m": (nb, nm, B, ...)}, "slstm": {"c", "n",
        "h", "m": (nb, B, D)}}, f32; ``seq_len`` plays no part."""
        del seq_len
        m = init_mlstm_state(self.cfg, batch, self.device)
        s = init_slstm_state(self.cfg, batch, self.device)
        return {"mlstm": {k: v.repeat(self.nb, self.nm, *[1] * v.ndim)
                          for k, v in m.items()},
                "slstm": {k: v.repeat(self.nb, *[1] * v.ndim)
                          for k, v in s.items()}}

    @torch.no_grad()
    def prefill(self, batch, max_len: int = 0):
        """Consume the prompt one position at a time through
        ``decode_step``; (cache, logits of the last position (B, 1, V)).
        ``max_len`` plays no part."""
        del max_len
        tokens = batch["tokens"]
        B, T = tokens.shape
        cache = self.init_cache(B, T)
        for t in range(T):
            logits, cache = self.decode_step(cache, tokens[:, t], 0)
        return cache, logits[:, None]

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        """tokens (B,) int; ``pos`` plays no part.  Writes the new state
        into ``cache`` in place; returns (logits (B, V), cache)."""
        del pos
        cfg = self.cfg
        nf = norm_fn(cfg.norm)
        x = self._tokens(tokens[:, None])
        mc, sc = cache["mlstm"], cache["slstm"]
        for b, (mls, sp) in enumerate(zip(
                map(self._cast_layers, self._layers("blocks.mlstm")),
                map(self._cast_layers, self._layers("blocks.slstm")))):
            for j, mp in enumerate(mls):
                dx, _ = mlstm_decode_step(
                    mp["p"], nf(x, mp["norm"]),
                    {k: v[b, j] for k, v in mc.items()}, cfg)
                x = x + dx
            dx, _ = slstm_decode_step(sp["p"], nf(x, sp["norm"]),
                                      {k: v[b] for k, v in sc.items()}, cfg)
            x = x + dx
        return self._head(x)[:, 0], cache
