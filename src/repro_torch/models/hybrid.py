"""Jamba-style hybrid LM: Mamba + attention interleaved 7:1, MoE every
``moe_period``-th FFN (Jamba-1.5: every 2nd).

The stack is organised as macro-blocks of ``attn_period`` layers, as in
the JAX package.  Within a block the Mamba sublayers are grouped by FFN
kind: the dense-FFN group, then the MoE-FFN group, then the attention
layer with its FFN.  The parameter count and FLOPs are the published
interleave's; only the order of the dense and MoE FFNs within a block
differs from it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.cuda import resolve_device
from .attention import init_kv_cache
from .config import ModelConfig
from .layers import (TreeModule, cross_entropy_loss, init_dense_,
                     init_normal_, norm_fn, param, rmsnorm, silu)
from .mamba import (MambaParams, _causal_conv, _ssm_inputs, mamba_block,
                    mamba_decode_step)
from .transformer import (CastMixin, DecoderLayer, ffn, layer_decode,
                          layer_fwd, layer_prefill, make_ffn, norm_scale)

#: time positions a chunk of ``_mamba_state_from_seq``'s (B, c, di, ds)
#: decay and input tensors
STATE_CHUNK = 64


class MambaLayer(TreeModule):
    """mamba, ffn (dense or MoE) and the scales norm1 and norm2."""

    def __init__(self, cfg: ModelConfig, ffn_cfg: ModelConfig, dtype, device):
        super().__init__()
        self.mamba = MambaParams(cfg, dtype, device)
        self.ffn = make_ffn(ffn_cfg, dtype, device)
        self.norm1 = norm_scale(cfg.d_model, device)
        self.norm2 = norm_scale(cfg.d_model, device)

    def init(self, generator: torch.Generator) -> None:
        self.mamba.init(generator)
        self.ffn.init(generator)
        nn.init.ones_(self.norm1)
        nn.init.ones_(self.norm2)


def _mamba_state_from_seq(mp: dict, x_seq: torch.Tensor, cfg: ModelConfig,
                          chunk: int = STATE_CHUNK) -> dict:
    """Decode-ready Mamba state after consuming x_seq (B, T, D): the final
    SSM state, by the sequential recurrence h = decay * h + inp, and the
    causal-conv tail (the last dc - 1 rows before the conv; fewer when
    T < dc - 1).  decay and inp are built ``chunk`` positions at a time:
    the same elementwise values as the JAX package's whole (B, T, di, ds)
    tensors."""
    p = mp["mamba"]
    T = x_seq.shape[1]
    di = cfg.mamba_expand * cfg.d_model
    up = x_seq @ p["w_in"]
    xi = silu(_causal_conv(up[..., :di], p["conv_w"], p["conv_b"]))
    Bm, _, dt, A = _ssm_inputs(p, xi, cfg)
    xdt = dt * xi.float()
    h = torch.zeros((x_seq.shape[0], di, cfg.mamba_d_state),
                    dtype=torch.float32, device=x_seq.device)
    for s in range(0, T, chunk):
        decay = torch.exp(dt[:, s:s + chunk, :, None] * A)    # (B, c, di, ds)
        inp = xdt[:, s:s + chunk, :, None] * Bm[:, s:s + chunk, None, :]
        for t in range(decay.shape[1]):
            h = decay[:, t] * h + inp[:, t]
    tail = up[..., :di][:, -(cfg.mamba_d_conv - 1):]
    return {"h": h, "conv": tail.to(x_seq.dtype)}


class HybridLM(CastMixin, nn.Module):
    """Parameters, under the JAX tree's names: ``embed`` [V, D],
    ``blocks.dense.<b>.<j>`` and (when a block holds more than one MoE FFN)
    ``blocks.moe.<b>.<j>`` (``MambaLayer``s), ``blocks.attn.<b>``
    (a ``DecoderLayer``: attention and its FFN) for each macro-block b,
    ``norm_f`` [D] (f32) and ``lm_head`` [D, V]."""

    HEADS = ("lm_head",)

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.attn_period < 2 or cfg.n_layers % cfg.attn_period:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} must be a "
                             f"multiple of attn_period {cfg.attn_period} "
                             ">= 2")
        dev = resolve_device(device)
        self.cfg = cfg
        self.nb = cfg.n_layers // cfg.attn_period
        per_block_moe = (cfg.attn_period // cfg.moe_period
                         if cfg.n_experts else 0)
        # the attention layer takes one MoE slot when any exist
        self.n_moe_mamba = max(per_block_moe - 1, 0)
        self.n_dense_mamba = cfg.attn_period - 1 - self.n_moe_mamba
        self.dense_cfg = cfg.scaled(n_experts=0, top_k=0)
        self.attn_ffn_cfg = cfg if per_block_moe else self.dense_cfg
        #: (stack, FFN config, sublayers a block) of the Mamba groups, in
        #: block order
        self.groups = [("dense", self.dense_cfg, self.n_dense_mamba)]
        if self.n_moe_mamba:
            self.groups.append(("moe", cfg, self.n_moe_mamba))
        self.STACKS = tuple(f"blocks.{g}" for g, *_ in self.groups) \
            + ("blocks.attn",)
        self.dtype = getattr(torch, cfg.dtype)
        self.pdtype = pd = getattr(torch, cfg.param_dtype)
        blocks = {g: nn.ModuleList(
            nn.ModuleList(MambaLayer(cfg, sub, pd, dev) for _ in range(n))
            for _ in range(self.nb)) for g, sub, n in self.groups}
        blocks["attn"] = nn.ModuleList(
            DecoderLayer(self.attn_ffn_cfg, pd, dev) for _ in range(self.nb))
        self.embed = param((cfg.vocab_size, cfg.d_model), pd, dev)
        self.blocks = nn.ModuleDict(blocks)
        self.norm_f = norm_scale(cfg.d_model, dev)
        self.lm_head = param((cfg.d_model, cfg.vocab_size), pd, dev)

    def init(self, generator: torch.Generator | None = None) -> "HybridLM":
        """As ``DecoderLM.init``."""
        if self.device.type == "meta":
            return self
        gen = generator or torch.Generator(self.device).manual_seed(0)
        for layer in self.modules():
            if isinstance(layer, (MambaLayer, DecoderLayer)):
                layer.init(gen)
        init_normal_(self.embed, 0.02, gen)
        nn.init.ones_(self.norm_f)
        init_dense_(self.lm_head, gen)
        return self

    def _tokens(self, tokens) -> torch.Tensor:
        return F.embedding(tokens, self.embed).to(self.dtype)

    def _head(self, x) -> torch.Tensor:
        return rmsnorm(x, self.norm_f) @ self._weight("lm_head")

    def _blocks(self):
        """Each macro-block's cast layers: ({group: [layer]}, attn layer)."""
        stacks = {g: self._layers(f"blocks.{g}") for g, *_ in self.groups}
        for b, ap in enumerate(self._layers("blocks.attn")):
            yield b, {g: self._cast_layers(s[b]) for g, s in stacks.items()}, \
                self._cast_layers(ap)

    def _mamba_sub(self, mp, x, sub_cfg, with_state: bool = False):
        """One Mamba sublayer with its FFN; with ``with_state`` also the
        decode state after x."""
        nf = norm_fn(self.cfg.norm)
        xn = nf(x, mp["norm1"])
        st = _mamba_state_from_seq(mp, xn, self.cfg) if with_state else None
        x = x + mamba_block(mp["mamba"], xn, self.cfg)
        x = x + ffn(mp["ffn"], nf(x, mp["norm2"]), sub_cfg)
        return x, st

    def logits(self, batch) -> torch.Tensor:
        x = self._tokens(batch["tokens"])

        def block(h, *groups):
            *mamba, ap = groups
            for (_, sub_cfg, _), layers in zip(self.groups, mamba):
                for mp in layers:
                    h, _ = self._mamba_sub(mp, h, sub_cfg)
            return layer_fwd(ap, h, self.attn_ffn_cfg)

        stacks = [self._layers(f"blocks.{g}") for g, *_ in self.groups]
        for b, ap in enumerate(self._layers("blocks.attn")):
            x = self._block(block, x, *(s[b] for s in stacks), ap)
        return self._head(x)

    def loss(self, batch) -> torch.Tensor:
        logits = self.logits(batch)
        return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:])

    # ---- serving ------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int) -> dict:
        """{"kv": {"k", "v": (nb, B, S, KV, hd)}, "dense" (and "moe"):
        {"h": (nb, n, B, di, ds) f32, "conv": (nb, n, B, dc - 1, di)}}."""
        cfg = self.cfg
        di = cfg.mamba_expand * cfg.d_model
        cache = {"kv": init_kv_cache(cfg, self.nb, batch, seq_len,
                                     self.dtype, self.device)}
        for g, _, n in self.groups:
            lead = (self.nb, n, batch)
            cache[g] = {
                "h": torch.zeros(lead + (di, cfg.mamba_d_state),
                                 dtype=torch.float32, device=self.device),
                "conv": torch.zeros(lead + (cfg.mamba_d_conv - 1, di),
                                    dtype=self.dtype, device=self.device)}
        return cache

    @torch.no_grad()
    def prefill(self, batch, max_len: int = 0):
        """Consume the prompt: (cache, logits of the last position
        (B, 1, V)); the cache as ``init_cache`` lays it out, the KV sized
        for ``max_len`` positions."""
        x = self._tokens(batch["tokens"])
        states = {g: {"h": [], "conv": []} for g, *_ in self.groups}
        ks, vs = [], []
        for _, mamba, ap in self._blocks():
            for g, sub_cfg, _ in self.groups:
                hs, convs = [], []
                for mp in mamba[g]:
                    x, st = self._mamba_sub(mp, x, sub_cfg, with_state=True)
                    hs.append(st["h"])
                    convs.append(st["conv"])
                states[g]["h"].append(torch.stack(hs))
                states[g]["conv"].append(torch.stack(convs))
            x, kv = layer_prefill(ap, x, self.attn_ffn_cfg, max_len=max_len)
            ks.append(kv["k"])
            vs.append(kv["v"])
        cache = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}
        cache.update((g, {k: torch.stack(v) for k, v in st.items()})
                     for g, st in states.items())
        return cache, self._head(x[:, -1:])

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        """tokens (B,) int; pos the absolute position (int).  Writes the
        token's K/V and the Mamba states into ``cache`` in place; returns
        (logits (B, V), cache)."""
        cfg = self.cfg
        nf = norm_fn(cfg.norm)
        x = self._tokens(tokens[:, None])
        kv = cache["kv"]
        for b, mamba, ap in self._blocks():
            for g, sub_cfg, _ in self.groups:
                for j, mp in enumerate(mamba[g]):
                    st = {k: v[b, j] for k, v in cache[g].items()}
                    dx, _ = mamba_decode_step(mp["mamba"],
                                              nf(x, mp["norm1"]), st, cfg)
                    x = x + dx
                    x = x + ffn(mp["ffn"], nf(x, mp["norm2"]), sub_cfg)
            x, _ = layer_decode(ap, x, {"k": kv["k"][b], "v": kv["v"][b]},
                                int(pos), self.attn_ffn_cfg)
        return self._head(x)[:, 0], cache
