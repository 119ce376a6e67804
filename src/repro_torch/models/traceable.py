"""The torch reference for the traceable decoder block.

``repro_torch.graph.trace.trace_block`` lowers a norm-free,
transcendental-free decoder block into ISAMIR kernels; this module is the
*other side* of that contract — the same block written directly in torch.
It computes in float64 on the given device and rounds to float32 at exactly
the traced node boundaries, mirroring the graph interpreter's per-node dtype
casts (the JAX package's ``models/traceable.py`` does the same in jax).

Over the tracer's ternary ``block_inputs`` every op of the block (dot
products, adds, relu, multiplication by powers of two) is exact in float64
in any summation order, so the reference itself is exact up to the
boundary roundings.  Where every tensor stays below 2^24 those roundings
are exact too, and a compiled graph's output is bit-exact against it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.cuda import resolve_device
from .config import ModelConfig


def _boundary(a: torch.Tensor) -> torch.Tensor:
    """One traced node boundary: round to the tensor dtype (f32)."""
    return a.to(torch.float32).to(torch.float64)


def block_reference(inputs: dict, cfg: ModelConfig, seq_len: int,
                    device=None, return_all: bool = False):
    """Evaluate the traceable decoder block in torch float64 on ``device``
    (default: the card); returns ``y2`` in float32, or with ``return_all`` a
    dict of every tensor of the traced graph, by the tracer's names, in
    float32 (each holds the f32 value at its node boundary).

    ``inputs`` (NumPy arrays or tensors) uses the tracer's tensor names:
    ``x``, per-head ``wq{h}`` / ``wk{h}`` / ``wv{h}`` / ``wo{h}``, and
    ``w_gate`` / ``w_up`` / ``w_down``.  ``seq_len`` is the traced T, the
    rows of ``x``.
    """
    dev = resolve_device(device)
    H, Dh = cfg.n_heads, cfg.hd
    halvings = (Dh.bit_length() - 1) // 2
    if 4 ** halvings != Dh:
        raise ValueError(f"head_dim {Dh} is not a power of 4")
    scale = 2.0 ** -halvings
    t = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v).to(dev, torch.float64)
         for k, v in inputs.items()}
    if t["x"].shape[0] != seq_len:
        raise ValueError(f"x has {t['x'].shape[0]} rows, not seq_len "
                         f"{seq_len}")
    env = {"x": _boundary(t["x"])}
    x = env["x"]
    attn = None
    for h in range(H):
        q = env[f"q{h}"] = _boundary(x @ t[f"wq{h}"])
        k = env[f"k{h}"] = _boundary(x @ t[f"wk{h}"])
        v = env[f"v{h}"] = _boundary(x @ t[f"wv{h}"])
        sraw = env[f"sraw{h}"] = _boundary(q @ k.T)
        s = env[f"s{h}"] = _boundary(torch.clamp_min(sraw * scale, 0.0))
        a = env[f"a{h}"] = _boundary(s @ v)
        p = env[f"p{h}"] = _boundary(a @ t[f"wo{h}"])
        if attn is not None:
            attn = env[f"attn{h}" if h < H - 1 else "attn"] = \
                _boundary(attn + p)
        else:
            attn = p
    y1 = env["y1"] = _boundary(x + attn)
    graw = env["graw"] = _boundary(y1 @ t["w_gate"])
    g = env["g"] = _boundary(torch.clamp_min(graw, 0.0))
    u = env["u"] = _boundary(y1 @ t["w_up"])
    hid = env["hid"] = _boundary(g + u)
    o = env["o"] = _boundary(hid @ t["w_down"])
    env["y2"] = _boundary(y1 + o)
    if return_all:
        return {name: a.to(torch.float32) for name, a in env.items()}
    return env["y2"].to(torch.float32)
