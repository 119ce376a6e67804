"""The plain reference of the ``whisper-medium-block`` configuration, and its
control: whisper's decoder stack and tied output head in plain PyTorch.

A copy of the program's ``models/whisper_block_reference.py`` kept with
the benchmark, so that a change to the program cannot move what ``correct``
is decided against.  It imports nothing of the program.  Each layer:
causal self-attention, cross-attention over the encoder's frames, a GELU
MLP, each added to the stream; then logits = x Eᵀ against the token
embedding E.  Projections are ``x @ W + b`` with W (fan in, fan out), the
keys' without a bias, as published.  Two departures, shared with the
program's tracer, which ISAMIR forces: no LayerNorm, and GELU in its tanh
form.

Float64 throughout, TF32 off.  ``precision`` rounds the operands of every
product (the projections, q kᵀ, the weights times the values, the head) as
``reference.lower`` does: ``"tf32"`` is the control of this f32
configuration.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import lower, strict

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
    uniform in +-1/sqrt(fan in), the token embedding standard normal."""
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


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return lower(a, precision) @ lower(b, precision)


def attention(xq: torch.Tensor, xkv: torch.Tensor, p: dict, pre: str,
              n_heads: int, causal: bool, precision: str) -> torch.Tensor:
    """Multi-head attention of the rows of ``xq`` over those of ``xkv``
    with the parameters ``p[pre + name]``: the output projection's
    result."""
    T, D = xq.shape
    dh = D // n_heads
    q = (_mm(xq, p[pre + "wq"], precision) + p[pre + "bq"])
    k = _mm(xkv, p[pre + "wk"], precision)
    v = _mm(xkv, p[pre + "wv"], precision) + p[pre + "bv"]
    q = q.view(T, n_heads, dh).transpose(0, 1)
    k = k.view(-1, n_heads, dh).transpose(0, 1)
    v = v.view(-1, n_heads, dh).transpose(0, 1)
    s = _mm(q, k.transpose(1, 2), precision) / math.sqrt(dh)
    if causal:
        keep = torch.ones(s.shape[1:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, -math.inf)
    a = _mm(torch.softmax(s, dim=-1), v, precision)
    return _mm(a.transpose(0, 1).reshape(T, D), p[pre + "wo"],
               precision) + p[pre + "bo"]


def decoder(params: dict, x: torch.Tensor, xa: torch.Tensor, n_heads: int,
            n_layers: int, precision: str = "config"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The stream after ``n_layers`` decoder layers from the embedded prompt
    ``x`` (T x d_model) over the frames ``xa``, and the logits (T x vocab);
    both float64, on ``x``'s device."""
    strict()
    p = {k: v.to(x.device, torch.float64) for k, v in params.items()}
    h, xa = x.double(), xa.double()
    for l in range(n_layers):
        h = h + attention(h, h, p, f"l{l}.sa.", n_heads, True, precision)
        h = h + attention(h, xa, p, f"l{l}.ca.", n_heads, False, precision)
        f = torch.nn.functional.gelu(
            _mm(h, p[f"l{l}.fc1"], precision) + p[f"l{l}.b1"],
            approximate="tanh")
        h = h + _mm(f, p[f"l{l}.fc2"], precision) + p[f"l{l}.b2"]
    return h, _mm(h, p["emb"].T, precision)
