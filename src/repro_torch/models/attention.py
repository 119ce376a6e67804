"""Attention: GQA, causal / sliding-window masks, rotary, KV-cache decode.

Shapes follow (B, T, H, hd).  GQA repeats KV heads by broadcast + reshape;
sliding-window attention masks beyond the window (Mixtral).  Decode attends a
single query token against the cache — for SWA the cache is a rolling buffer
of ``window`` positions.

The numerics are the JAX package's: scores in the activation dtype, divided
by ``hd ** 0.5`` rounded to that dtype (JAX's weak-typed scalar), masked with
``NEG_INF``, softmax in f32 and cast back before the PV product.  No fused
attention kernel is used: it would round differently.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.ctx import constrain
from .config import ModelConfig
from .layers import TreeModule, apply_rotary, init_dense_, param, rotary

NEG_INF = -1e30


class Attention(TreeModule):
    """wq [D, H*hd], wk and wv [D, KV*hd], wo [H*hd, D], and with
    ``qkv_bias`` the biases bq, bk, bv."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = param((D, H * hd), dtype, device)
        self.wk = param((D, KV * hd), dtype, device)
        self.wv = param((D, KV * hd), dtype, device)
        self.wo = param((H * hd, D), dtype, device)
        if cfg.qkv_bias:
            self.bq = param((H * hd,), dtype, device)
            self.bk = param((KV * hd,), dtype, device)
            self.bv = param((KV * hd,), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            init_dense_(w, generator)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                torch.nn.init.zeros_(getattr(self, name))


def score_scale(hd: int, dtype: torch.dtype) -> float:
    """``hd ** 0.5`` rounded to ``dtype``: the divisor JAX applies to
    scores held in that dtype (128 ** 0.5 is 11.3125 in bf16)."""
    return float(torch.tensor(hd ** 0.5, dtype=dtype))


def _project_qkv(p, x, cfg: ModelConfig):
    B, T, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (constrain(q.reshape(B, T, H, hd), "heads"),
            constrain(k.reshape(B, T, KV, hd), "heads"),
            constrain(v.reshape(B, T, KV, hd), "heads"))


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each KV head."""
    B, S, KV, hd = k.shape
    rep = n_heads // KV
    return k[:, :, :, None, :].expand(B, S, KV, rep, hd) \
        .reshape(B, S, n_heads, hd)


#: query-chunk size above which attention runs chunked (memory O(T*chunk))
ATTN_CHUNK = 2048


def _softmax_to(scores: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(scores, dim=-1, dtype=torch.float32).to(dtype)


def _attend(q, k, v, positions, cfg: ModelConfig, causal: bool):
    """Softmax attention on projected/rotated q, k, v (B, T|S, H, hd).
    A prompt longer than ``ATTN_CHUNK`` and a multiple of it runs in query
    chunks: exact softmax per row, activation memory O(T * chunk)."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    scale = score_scale(hd, q.dtype)

    def block(q_blk, pos_blk):
        scores = constrain(torch.einsum("bthd,bshd->bhts", q_blk, k),
                           "scores") / scale
        if causal:
            i = pos_blk[:, None]
            j = positions[None, :S] if positions.shape[0] >= S \
                else torch.arange(S, device=q.device)[None, :]
            mask = j <= i
            if cfg.sliding_window:
                mask &= j > i - cfg.sliding_window
            scores = scores.masked_fill_(~mask, NEG_INF)
        w = _softmax_to(scores, q_blk.dtype)
        del scores
        return torch.einsum("bhts,bshd->bthd", w, v)

    if T <= ATTN_CHUNK or T % ATTN_CHUNK:
        return block(q, positions)
    outs = [block(q[:, s:s + ATTN_CHUNK], positions[s:s + ATTN_CHUNK])
            for s in range(0, T, ATTN_CHUNK)]
    return torch.cat(outs, dim=1)


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig,
              causal: bool = True,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full self-attention over (B, T, D)."""
    B, T, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q, k, v = _project_qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(T, device=x.device)
    cos, sin = rotary(positions, hd, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    out = _attend(q, k, v, positions, cfg, causal)
    out = constrain(out, "heads").reshape(B, T, H * hd)
    return constrain(out @ p["wo"], "residual")


# --------------------------------------------------------------------------- #
# KV-cache serving
# --------------------------------------------------------------------------- #


def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, seq_len: int,
                  dtype, device) -> dict:
    """Cache of ``n_layers`` attention layers, (L, B, S, KV, hd) each for K
    and V.  SWA archs keep a rolling buffer of ``sliding_window`` slots;
    full attention keeps all ``seq_len``."""
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (n_layers, batch, S, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_attention(p, x, cfg: ModelConfig, max_len: int = 0):
    """Run attention AND return the layer cache, sized for subsequent decode
    up to ``max_len`` positions (rolling buffer for SWA).  QKV is projected
    once and shared between the attention output and the cache."""
    B, T, D = x.shape
    H = cfg.n_heads
    q, k, v = _project_qkv(p, x, cfg)
    pos = torch.arange(T, device=x.device)
    cos, sin = rotary(pos, cfg.hd, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    out = _attend(q, _expand_kv(k, H), _expand_kv(v, H), pos, cfg,
                  causal=True)
    out = constrain(out, "heads").reshape(B, T, H * cfg.hd)
    out = constrain(out @ p["wo"], "residual")
    max_len = max(max_len, T)
    if cfg.sliding_window:
        S = min(cfg.sliding_window, max_len)
        if T > S:
            k, v = k[:, -S:], v[:, -S:]
        elif S > T:
            k = F.pad(k, (0, 0, 0, 0, 0, S - T))
            v = F.pad(v, (0, 0, 0, 0, 0, S - T))
        # rolling-buffer layout: position p lives at slot p % S
        shift = T % S if T > S else 0
        k = torch.roll(k, shift, dims=1)
        v = torch.roll(v, shift, dims=1)
    elif max_len > T:
        k = F.pad(k, (0, 0, 0, 0, 0, max_len - T))
        v = F.pad(v, (0, 0, 0, 0, 0, max_len - T))
    return out, {"k": k, "v": v}


def decode_attention(p: dict, x: torch.Tensor, cache: dict, pos: int,
                     cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, D), cache K/V (B, S, KV, hd), pos the
    current absolute position.  Writes the new K/V into ``cache`` in place
    and returns (out (B, 1, D), cache).

    The slot is ``pos % S`` for SWA and ``pos`` otherwise, clamped to
    ``S - 1`` as ``jax.lax.dynamic_update_slice`` clamps its start: a
    full-attention decode at ``pos >= S`` overwrites the last slot."""
    B, _, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    S = cache["k"].shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    # a fill on the device: a tensor built from a host list would copy, and
    # that copy waits for the queue
    cos, sin = rotary(torch.arange(pos, pos + 1, device=x.device), hd,
                      cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)

    slot = pos % S if cfg.sliding_window else min(max(pos, 0), S - 1)
    ck, cv = cache["k"], cache["v"]
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]

    kk = _expand_kv(ck, H)   # (B, S, H, hd)
    vv = _expand_kv(cv, H)
    scores = torch.einsum("bthd,bshd->bhts", q, kk)[:, :, 0] \
        / score_scale(hd, q.dtype)
    span = torch.arange(S, device=x.device)
    if cfg.sliding_window:
        age = (pos % S - span) % S          # rolling-buffer age of each slot
        valid = (age < cfg.sliding_window) & (span < S) & (age <= pos)
    else:
        valid = span <= pos
    scores = scores.masked_fill_(~valid, NEG_INF)
    w = _softmax_to(scores, x.dtype)
    out = torch.einsum("bhs,bshd->bhd", w, vv).reshape(B, H * hd)
    out = (out @ p["wo"]).reshape(B, 1, D)
    return out, cache


def cross_attention(p: dict, x: torch.Tensor, kv_src: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper): queries from x, keys and
    values from the encoder output (no mask, no rotary, no bias)."""
    B, T, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S = kv_src.shape[1]
    q = (x @ p["wq"]).reshape(B, T, H, hd)
    k = (kv_src @ p["wk"]).reshape(B, S, KV, hd)
    v = (kv_src @ p["wv"]).reshape(B, S, KV, hd)
    return cached_cross_attention(p, q, k, v)


def cached_cross_attention(p: dict, q, k, v) -> torch.Tensor:
    """Cross attention of projected queries (B, T, H, hd) against projected
    encoder keys and values (B, S, KV, hd), through ``wo``."""
    B, T, H, hd = q.shape
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scores = torch.einsum("bthd,bshd->bhts", q, k) / score_scale(hd, q.dtype)
    w = _softmax_to(scores, q.dtype)
    out = torch.einsum("bhts,bshd->bthd", w, v).reshape(B, T, H * hd)
    return out @ p["wo"]
