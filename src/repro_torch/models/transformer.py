"""Decoder-only transformer LM (dense / MoE / VLM backbone).

The layer stack is an ``nn.ModuleList`` walked in a Python loop.  Each
layer's parameters are cast from ``param_dtype`` to the activation dtype
where they are stored in ``param_dtype`` (norm scales and the MoE router
included) before the layer runs, as in the JAX package; the final norm
stays f32 and the embedding is cast after the lookup (the same values as
casting the table first).  ``cast_weights()`` makes those casts once for a
block of calls, which gives the same values; it casts under ``no_grad``, so
it is for serving only, and a loss is taken outside it (the per-call cast
is differentiable).  With ``cfg.remat``, each layer of ``logits`` (its cast
included) is recomputed in the backward pass, as the JAX package's
``jax.checkpoint`` of its scanned body (``CastMixin._block``).
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.ctx import constrain
from ..kernels.cuda import resolve_device
from .attention import (Attention, attention, decode_attention,
                        init_kv_cache, prefill_attention)
from .config import ModelConfig
from .layers import (TreeModule, cast_tree, cross_entropy_loss, embed_lookup,
                     gathered, init_dense_, init_normal_, norm_fn, param,
                     rmsnorm, silu)
from .moe import MoE, moe_ffn


class SwiGLU(TreeModule):
    """w_gate and w_up [D, F], w_down [F, D]."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        self.w_gate = param((D, Fd), dtype, device)
        self.w_up = param((D, Fd), dtype, device)
        self.w_down = param((Fd, D), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            init_dense_(w, generator)


def make_ffn(cfg: ModelConfig, dtype, device) -> TreeModule:
    return MoE(cfg, dtype, device) if cfg.n_experts \
        else SwiGLU(cfg, dtype, device)


def ffn(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.n_experts:
        return moe_ffn(p, x, cfg)
    g = silu(x @ p["w_gate"])
    u = x @ p["w_up"]
    h = constrain(g * u, "ffn_hidden")
    return constrain(h @ p["w_down"], "residual")


def norm_scale(d_model: int, device) -> nn.Parameter:
    return param((d_model,), torch.float32, device)


class DecoderLayer(TreeModule):
    """attn, ffn, and with ``rmsnorm`` the scales norm1 and norm2."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.attn = Attention(cfg, dtype, device)
        self.ffn = make_ffn(cfg, dtype, device)
        if cfg.norm == "rmsnorm":
            self.norm1 = norm_scale(cfg.d_model, device)
            self.norm2 = norm_scale(cfg.d_model, device)

    def init(self, generator: torch.Generator) -> None:
        self.attn.init(generator)
        self.ffn.init(generator)
        for name in ("norm1", "norm2"):
            if hasattr(self, name):
                nn.init.ones_(getattr(self, name))


def _norms(p, cfg):
    nf = norm_fn(cfg.norm)
    n1 = functools.partial(nf, scale=p.get("norm1"))
    n2 = functools.partial(nf, scale=p.get("norm2"))
    return n1, n2


def layer_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    n1, n2 = _norms(p, cfg)
    x = constrain(x, "residual")
    x = x + attention(p["attn"], n1(x), cfg)
    x = x + ffn(p["ffn"], n2(x), cfg)
    return constrain(x, "residual")


def layer_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  max_len: int = 0):
    n1, n2 = _norms(p, cfg)
    a, cache = prefill_attention(p["attn"], n1(x), cfg, max_len=max_len)
    x = x + a
    x = x + ffn(p["ffn"], n2(x), cfg)
    return x, cache


def layer_decode(p: dict, x: torch.Tensor, cache: dict, pos: int,
                 cfg: ModelConfig):
    n1, n2 = _norms(p, cfg)
    a, cache = decode_attention(p["attn"], n1(x), cache, pos, cfg)
    x = x + a
    x = x + ffn(p["ffn"], n2(x), cfg)
    return x, cache


class CastMixin:
    """The layer cast, per call or once for a block (``cast_weights``).

    ``STACKS`` names the layer stacks by their path from the model
    (``layers``, or ``blocks.mlstm``): an ``nn.ModuleList`` of layers, or
    of such lists (one a macro-block)."""

    _cast_once: dict | None = None

    def _cast(self, tree: dict) -> dict:
        return cast_tree(tree, self.pdtype, self.dtype)

    def _cast_layers(self, module):
        """A layer module as its cast tree; a list of them as a list; a
        tree cast already as it is."""
        if isinstance(module, (nn.ModuleList, list)):
            return [self._cast_layers(m) for m in module]
        if isinstance(module, dict):
            return module
        return self._cast(module.tree())

    def _layers(self, name: str) -> list:
        """The layers of the stack ``name``: cast trees under
        ``cast_weights``, else the modules (a macro-block's sublayers as a
        ``ModuleList``), each cast at use by ``_cast_layers`` (inside
        ``_block`` on the loss path)."""
        if self._cast_once is not None:
            return self._cast_once[name]
        return list(self.get_submodule(name))

    def _block(self, fn, x: torch.Tensor, *layers) -> torch.Tensor:
        """``fn(x, *trees)``, each of ``layers`` (from ``_layers``) given as
        its tree cast to the activation dtype.  With ``cfg.remat`` while
        autograd records, the block, its cast included, is recomputed in
        the backward pass (``torch.utils.checkpoint``), as the JAX package
        wraps its scanned body in ``jax.checkpoint``; values are
        unchanged."""
        def body(h):
            return fn(h, *(self._cast_layers(m) for m in layers))

        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(body, x, use_reentrant=False)
        return body(x)

    def _weight(self, name: str) -> torch.Tensor:
        if self._cast_once is not None:
            return self._cast_once[name]
        return gathered(getattr(self, name).to(self.dtype))

    @contextlib.contextmanager
    def cast_weights(self):
        """Within the block every weight the layers and the head read is cast
        to the activation dtype once, not on every call: the same values,
        for the memory of one more copy in that dtype."""
        if self._cast_once is not None:     # nested: already cast
            yield self
            return
        with torch.no_grad():
            once = {name: self._cast_layers(self.get_submodule(name))
                    for name in self.STACKS}
            once.update((name, getattr(self, name).to(self.dtype))
                        for name in self.HEADS)
        self._cast_once = once
        try:
            yield self
        finally:
            self._cast_once = None

    @property
    def device(self) -> torch.device:
        return self.embed.device


class DecoderLM(CastMixin, nn.Module):
    """Families: dense (olmo/qwen*), moe (mixtral/phi3.5-moe), vlm (llava).

    Parameters, under the JAX tree's names: ``embed`` [V, D], ``layers`` (an
    ``nn.ModuleList`` of ``DecoderLayer``), ``norm_f`` [D] (f32) and, unless
    the embeddings are tied, ``lm_head`` [D, V].  ``init`` fills them."""

    STACKS = ("layers",)

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.pdtype = getattr(torch, cfg.param_dtype)
        self.embed = param((cfg.vocab_size, cfg.d_model), self.pdtype, dev)
        self.layers = nn.ModuleList(DecoderLayer(cfg, self.pdtype, dev)
                                    for _ in range(cfg.n_layers))
        self.norm_f = norm_scale(cfg.d_model, dev)
        if not cfg.tie_embeddings:
            self.lm_head = param((cfg.d_model, cfg.vocab_size), self.pdtype,
                                 dev)
        self.HEADS = () if cfg.tie_embeddings else ("lm_head",)

    # ---- parameters -------------------------------------------------------
    def init(self, generator: torch.Generator | None = None) -> "DecoderLM":
        """Draw every parameter from ``generator`` (a ``torch.Generator`` on
        the model's device; seed 0 when None), with the JAX init's
        distributions.  A model on the ``meta`` device is left as it is."""
        if self.device.type == "meta":
            return self
        gen = generator or torch.Generator(self.device).manual_seed(0)
        for layer in self.layers:
            layer.init(gen)
        init_normal_(self.embed, 0.02, gen)
        nn.init.ones_(self.norm_f)
        if not self.cfg.tie_embeddings:
            init_dense_(self.lm_head, gen)
        return self

    # ---- embedding / head ----------------------------------------------------
    def _embed_tokens(self, batch) -> torch.Tensor:
        x = constrain(embed_lookup(batch["tokens"], self.embed)
                      .to(self.dtype), "residual")
        if self.cfg.family == "vlm" and "patch_embeds" in batch:
            # anyres frontend stub: precomputed patch embeddings are prefixed
            x = torch.cat([batch["patch_embeds"].to(self.dtype), x], dim=1)
        return x

    def _head(self, x) -> torch.Tensor:
        w = gathered(self.embed.to(self.dtype)).T if self.cfg.tie_embeddings \
            else self._weight("lm_head")
        return constrain(x @ w, "logits")

    # ---- layer stack -----------------------------------------------------------
    def _run_layers(self, x) -> torch.Tensor:
        for layer in self._layers("layers"):
            x = self._block(lambda h, lp: layer_fwd(lp, h, self.cfg), x,
                            layer)
        return x

    def logits(self, batch) -> torch.Tensor:
        x = self._embed_tokens(batch)
        x = self._run_layers(x)
        x = rmsnorm(x, self.norm_f)
        return self._head(x)

    def loss(self, batch) -> torch.Tensor:
        logits = self.logits(batch)
        T = batch["tokens"].shape[1]
        logits_txt = logits[:, -T:]                      # vlm: text positions
        return cross_entropy_loss(logits_txt[:, :-1], batch["tokens"][:, 1:])

    # ---- serving ----------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int) -> dict:
        return {"kv": init_kv_cache(self.cfg, self.cfg.n_layers, batch,
                                    seq_len, self.dtype, self.device)}

    @torch.no_grad()
    def prefill(self, batch, max_len: int = 0):
        """Consume the prompt: (cache {"kv": {"k", "v": (L, B, S, KV, hd)}},
        logits of the last position (B, 1, V))."""
        x = self._embed_tokens(batch)
        ks, vs = [], []
        for lp in map(self._cast_layers, self._layers("layers")):
            x, cache = layer_prefill(lp, x, self.cfg, max_len=max_len)
            ks.append(cache["k"])
            vs.append(cache["v"])
        x = rmsnorm(x[:, -1:], self.norm_f)
        return ({"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}},
                self._head(x))

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        """tokens (B,) int; pos the absolute position (int).  Writes the
        token's K/V into ``cache`` in place; returns (logits (B, V), cache)."""
        x = embed_lookup(tokens[:, None], self.embed).to(self.dtype)
        kv = cache["kv"]
        for i, lp in enumerate(map(self._cast_layers,
                                  self._layers("layers"))):
            x, _ = layer_decode(lp, x, {"k": kv["k"][i], "v": kv["v"][i]},
                                int(pos), self.cfg)
        x = rmsnorm(x, self.norm_f)
        return self._head(x)[:, 0], cache
