"""whisper's decoder stack and its tied output head in plain torch float64:
the reference ``graph.trace.trace_whisper_decoder`` is held to.

The layer is whisper's (arXiv:2212.04356; ``ResidualAttentionBlock`` with
cross-attention in openai/whisper's ``model.py``): causal self-attention,
cross-attention over the encoder's frames, a GELU MLP, each added to the
stream, and logits = x Eᵀ against the token embedding E.  Projections are
``x @ W + b`` with W (fan in, fan out); the keys' projections have no bias,
as published.  It shares the tracer's two departures, which ISAMIR forces:
no LayerNorm (three a layer, one before the head) and GELU in its tanh
form.  Its softmax is the usual one: that the graph does not subtract the
row max changes roundings, not the function.

It imports nothing but torch, and computes in float64 with TF32 off.
"""
from __future__ import annotations

import math

import torch

#: the parameters of one attention block, under ``l{l}.sa.`` or ``l{l}.ca.``
ATTENTION = ("wq", "bq", "wk", "wv", "bv", "wo", "bo")


def param_shapes(d_model: int, d_ff: int, vocab: int,
                 n_layers: int) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, in the order ``init_params`` draws
    them."""
    D, F = d_model, d_ff
    shapes: dict[str, tuple[int, ...]] = {}
    for l in range(n_layers):
        for blk in ("sa", "ca"):
            for w in ATTENTION:
                shapes[f"l{l}.{blk}.{w}"] = (D, D) if w[0] == "w" else (D,)
        shapes.update({f"l{l}.fc1": (D, F), f"l{l}.b1": (F,),
                       f"l{l}.fc2": (F, D), f"l{l}.b2": (D,)})
    shapes["emb"] = (vocab, D)
    return shapes


def init_params(d_model: int, d_ff: int, vocab: int, n_layers: int,
                generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Random parameters from ``generator``: each linear weight and bias
    uniform in ±1/sqrt(fan in), the token embedding standard normal."""
    out = {}
    for name, shape in param_shapes(d_model, d_ff, vocab, n_layers).items():
        if name == "emb":
            out[name] = torch.randn(shape, generator=generator, device=device,
                                    dtype=dtype)
            continue
        fan_in = d_ff if name.endswith((".fc2", ".b2")) else d_model
        u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
        out[name] = (2 * u - 1) / math.sqrt(fan_in)
    return out


def attention(xq: torch.Tensor, xkv: torch.Tensor, p: dict, pre: str,
              n_heads: int, causal: bool) -> torch.Tensor:
    """Multi-head attention of the rows of ``xq`` over those of ``xkv``,
    with the parameters ``p[pre + name]``; the output projection's result."""
    T, D = xq.shape
    dh = D // n_heads
    q = (xq @ p[pre + "wq"] + p[pre + "bq"]).view(T, n_heads, dh)
    k = (xkv @ p[pre + "wk"]).view(-1, n_heads, dh)
    v = (xkv @ p[pre + "wv"] + p[pre + "bv"]).view(-1, n_heads, dh)
    s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(dh)
    if causal:
        keep = torch.ones(s.shape[1:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, -math.inf)
    a = torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v)
    return a.reshape(T, D) @ p[pre + "wo"] + p[pre + "bo"]


def decoder(params: dict, x: torch.Tensor, xa: torch.Tensor, n_heads: int,
            n_layers: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The stream after ``n_layers`` decoder layers from the embedded prompt
    ``x`` (T x d_model) over the frames ``xa``, and the logits; both
    float64, on ``x``'s device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = {k: v.to(x.device, torch.float64) for k, v in params.items()}
    h, xa = x.double(), xa.double()
    for l in range(n_layers):
        h = h + attention(h, h, p, f"l{l}.sa.", n_heads, True)
        h = h + attention(h, xa, p, f"l{l}.ca.", n_heads, False)
        f = torch.nn.functional.gelu(h @ p[f"l{l}.fc1"] + p[f"l{l}.b1"],
                                     approximate="tanh")
        h = h + f @ p[f"l{l}.fc2"] + p[f"l{l}.b2"]
    return h, h @ p["emb"].T
