"""Whisper-style encoder-decoder backbone.

The audio conv frontend is a stub: the batch carries precomputed frame
embeddings (B, T_audio, d_model) that go straight to the encoder.  The
encoder's self-attention is non-causal and takes rotary, as in the JAX
package.  The decoder is a causal transformer with cross-attention; decode
caches both the self-attention KV and the per-layer cross KV projections."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.cuda import resolve_device
from .attention import (Attention, attention, cached_cross_attention,
                        cross_attention, decode_attention, init_kv_cache,
                        prefill_attention)
from .config import ModelConfig
from .layers import (TreeModule, cross_entropy_loss, init_dense_,
                     init_normal_, norm_fn, param, rmsnorm)
from .transformer import CastMixin, ffn, make_ffn, norm_scale


class EncoderLayer(TreeModule):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.attn = Attention(cfg, dtype, device)
        self.ffn = make_ffn(cfg, dtype, device)
        self.norm1 = norm_scale(cfg.d_model, device)
        self.norm2 = norm_scale(cfg.d_model, device)

    def init(self, generator: torch.Generator) -> None:
        self.attn.init(generator)
        self.ffn.init(generator)
        nn.init.ones_(self.norm1)
        nn.init.ones_(self.norm2)


class DecoderBlock(TreeModule):
    """Self-attention (``self`` in the JAX tree), cross-attention, ffn and
    three norm scales."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.add_module("self", Attention(cfg, dtype, device))
        self.cross = Attention(cfg, dtype, device)
        self.ffn = make_ffn(cfg, dtype, device)
        self.norm1 = norm_scale(cfg.d_model, device)
        self.norm2 = norm_scale(cfg.d_model, device)
        self.norm3 = norm_scale(cfg.d_model, device)

    def init(self, generator: torch.Generator) -> None:
        for name in ("self", "cross", "ffn"):
            self.get_submodule(name).init(generator)
        for w in (self.norm1, self.norm2, self.norm3):
            nn.init.ones_(w)


class WhisperModel(CastMixin, nn.Module):
    """Parameters: ``embed`` [V, D], ``enc`` and ``dec`` (``nn.ModuleList``s),
    ``norm_enc`` and ``norm_f`` [D] (f32), ``lm_head`` [D, V]."""

    STACKS = ("enc", "dec")
    HEADS = ("lm_head",)

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.encoder_layers <= 0:
            raise ValueError(f"{cfg.name}: whisper needs encoder layers")
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.pdtype = getattr(torch, cfg.param_dtype)
        pd = self.pdtype
        self.embed = param((cfg.vocab_size, cfg.d_model), pd, dev)
        self.enc = nn.ModuleList(EncoderLayer(cfg, pd, dev)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(DecoderBlock(cfg, pd, dev)
                                 for _ in range(cfg.n_layers))
        self.norm_enc = norm_scale(cfg.d_model, dev)
        self.norm_f = norm_scale(cfg.d_model, dev)
        self.lm_head = param((cfg.d_model, cfg.vocab_size), pd, dev)

    def init(self, generator: torch.Generator | None = None
             ) -> "WhisperModel":
        """As ``DecoderLM.init``."""
        if self.device.type == "meta":
            return self
        gen = generator or torch.Generator(self.device).manual_seed(0)
        for layer in (*self.enc, *self.dec):
            layer.init(gen)
        init_normal_(self.embed, 0.02, gen)
        nn.init.ones_(self.norm_enc)
        nn.init.ones_(self.norm_f)
        init_dense_(self.lm_head, gen)
        return self

    def _tokens(self, tokens) -> torch.Tensor:
        return F.embedding(tokens, self.embed).to(self.dtype)

    # ---- encoder --------------------------------------------------------------
    def encode(self, audio_embeds) -> torch.Tensor:
        cfg = self.cfg
        nf = norm_fn(cfg.norm)
        x = audio_embeds.to(self.dtype)

        def body(h, lp):
            h = h + attention(lp["attn"], nf(h, lp["norm1"]), cfg,
                              causal=False)
            return h + ffn(lp["ffn"], nf(h, lp["norm2"]), cfg)

        for layer in self._layers("enc"):
            x = self._block(body, x, layer)
        return rmsnorm(x, self.norm_enc)

    # ---- decoder (teacher forcing) ----------------------------------------------
    def logits(self, batch) -> torch.Tensor:
        cfg = self.cfg
        nf = norm_fn(cfg.norm)
        enc_out = self.encode(batch["audio_embeds"])
        x = self._tokens(batch["tokens"])

        def body(h, lp):
            h = h + attention(lp["self"], nf(h, lp["norm1"]), cfg)
            h = h + cross_attention(lp["cross"], nf(h, lp["norm2"]), enc_out,
                                    cfg)
            return h + ffn(lp["ffn"], nf(h, lp["norm3"]), cfg)

        for layer in self._layers("dec"):
            x = self._block(body, x, layer)
        x = rmsnorm(x, self.norm_f)
        return x @ self._weight("lm_head")

    def loss(self, batch) -> torch.Tensor:
        logits = self.logits(batch)
        return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:])

    # ---- serving -----------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int) -> dict:
        cfg = self.cfg
        Ta = cfg.frontend_tokens or 1500
        shape = (cfg.n_layers, batch, Ta, cfg.n_kv_heads, cfg.hd)
        return {"kv": init_kv_cache(cfg, cfg.n_layers, batch, seq_len,
                                    self.dtype, self.device),
                "cross": {n: torch.zeros(shape, dtype=self.dtype,
                                         device=self.device)
                          for n in ("k", "v")}}

    @torch.no_grad()
    def prefill(self, batch, max_len: int = 0):
        """Encode audio, consume the text prompt, cache self+cross KV."""
        cfg = self.cfg
        nf = norm_fn(cfg.norm)
        enc_out = self.encode(batch["audio_embeds"])
        x = self._tokens(batch["tokens"])
        B, Ta, D = enc_out.shape
        KV, hd = cfg.n_kv_heads, cfg.hd
        caches = {"k": [], "v": [], "ck": [], "cv": []}
        for lp in map(self._cast_layers, self._layers("dec")):
            a, kv = prefill_attention(lp["self"], nf(x, lp["norm1"]), cfg,
                                      max_len=max_len)
            x = x + a
            caches["k"].append(kv["k"])
            caches["v"].append(kv["v"])
            caches["ck"].append((enc_out @ lp["cross"]["wk"])
                                .reshape(B, Ta, KV, hd))
            caches["cv"].append((enc_out @ lp["cross"]["wv"])
                                .reshape(B, Ta, KV, hd))
            x = x + cross_attention(lp["cross"], nf(x, lp["norm2"]), enc_out,
                                    cfg)
            x = x + ffn(lp["ffn"], nf(x, lp["norm3"]), cfg)
        x = rmsnorm(x[:, -1:], self.norm_f)
        stack = {n: torch.stack(c) for n, c in caches.items()}
        return ({"kv": {"k": stack["k"], "v": stack["v"]},
                 "cross": {"k": stack["ck"], "v": stack["cv"]}},
                x @ self._weight("lm_head"))

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        """As ``DecoderLM.decode_step``; the cross KV is read, not written."""
        cfg = self.cfg
        nf = norm_fn(cfg.norm)
        x = self._tokens(tokens[:, None])
        H, hd = cfg.n_heads, cfg.hd
        B = x.shape[0]
        kv, cross = cache["kv"], cache["cross"]
        for i, lp in enumerate(map(self._cast_layers, self._layers("dec"))):
            a, _ = decode_attention(lp["self"], nf(x, lp["norm1"]),
                                    {"k": kv["k"][i], "v": kv["v"][i]},
                                    int(pos), cfg)
            x = x + a
            # cross attention against the cached encoder projections
            q = (nf(x, lp["norm2"]) @ lp["cross"]["wq"]).reshape(B, 1, H, hd)
            x = x + cached_cross_attention(lp["cross"], q, cross["k"][i],
                                           cross["v"][i])
            x = x + ffn(lp["ffn"], nf(x, lp["norm3"]), cfg)
        x = rmsnorm(x, self.norm_f)
        return (x @ self._weight("lm_head"))[:, 0], cache
