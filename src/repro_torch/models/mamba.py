"""Mamba selective-SSM block (for the Jamba hybrid).

The full-sequence form loops over time-chunks; inside a chunk the
first-order recurrence runs as ``lax.associative_scan``'s odd/even
recursion (``associative_scan``): the same combines in the same order as
the JAX package, O(log c) tensor ops a chunk.  Decode carries the
(d_inner, d_state) state plus the causal-conv tail, writes both in place
and costs O(1) a token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import (TreeModule, divisor_chunk, init_dense_, init_normal_,
                     param, silu, softplus)


class MambaParams(TreeModule):
    """w_in [D, 2di] (x and gate), conv_w [dc, di] and conv_b [di] (the
    depthwise causal conv), w_bcdt [di, 2ds + 1] (B, C and dt), and in f32
    dt_bias [di], A_log [di, ds] and D_skip [di]; w_out [di, D]."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D = cfg.d_model
        di = cfg.mamba_expand * D
        ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
        f32 = torch.float32
        self.w_in = param((D, 2 * di), dtype, device)
        self.conv_w = param((dc, di), dtype, device)
        self.conv_b = param((di,), dtype, device)
        self.w_bcdt = param((di, 2 * ds + 1), dtype, device)
        self.dt_bias = param((di,), f32, device)
        self.A_log = param((di, ds), f32, device)
        self.D_skip = param((di,), f32, device)
        self.w_out = param((di, D), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        init_dense_(self.w_in, generator)
        init_normal_(self.conv_w, 0.1, generator)
        init_dense_(self.w_bcdt, generator)
        init_dense_(self.w_out, generator)
        ds = self.A_log.shape[1]
        a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                       device=self.A_log.device))
        with torch.no_grad():
            self.conv_b.zero_()
            self.dt_bias.fill_(-4.0)
            self.A_log.copy_(a_log.expand_as(self.A_log))
            self.D_skip.fill_(1.0)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x (B, T, di), w (dc, di); dc adds, each
    rounded to x's dtype."""
    dc, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    out = torch.zeros_like(x)
    for i in range(dc):
        out = out + pad[:, i:i + T] * w[i]
    return out + b


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along axis 0 (len(a) - len(b) is 0 or
    1)."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + a.shape[1:])
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(fn, elems: list) -> list:
    """``lax.associative_scan(fn, elems, axis=0)``: the prefix combine of
    ``elems`` (a list of tensors of one length) by ``fn(a, b) -> list``,
    by the same odd/even recursion, so each element is combined in the
    same order."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = associative_scan(fn, fn([e[0:-1:2] for e in elems],
                                  [e[1::2] for e in elems]))
    rest = [e[2::2] for e in elems]
    even = fn([e[:-1] for e in odd] if n % 2 == 0 else odd, rest)
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _ssm_combine(a: list, b: list) -> list:
    """(decay, input) pairs: applying a, then b."""
    da, ia = a
    db, ib = b
    return [da * db, ib + db * ia]


def _selective_scan(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t.

    x: (B, T, di); dt: (B, T, di); A: (di, ds); Bm/Cm: (B, T, ds).  The
    (c, B, di, ds) decay and input tensors are built one chunk at a time."""
    Bb, T, di = x.shape
    nc = max(1, T // chunk)
    chunk = T // nc
    h = torch.zeros((Bb, di, A.shape[1]), dtype=x.dtype, device=x.device)
    ys = []
    for c in range(nc):
        x_c, dt_c, B_c, C_c = (a[:, c * chunk:(c + 1) * chunk].transpose(0, 1)
                               for a in (x, dt, Bm, Cm))
        decay = torch.exp(dt_c[..., None] * A)             # (c, B, di, ds)
        inp = (dt_c * x_c)[..., None] * B_c[:, :, None, :]
        d_scan, i_scan = associative_scan(_ssm_combine, [decay, inp])
        hs = d_scan * h + i_scan
        ys.append(torch.einsum("cbis,cbs->cbi", hs, C_c))
        h = hs[-1]
    return torch.cat(ys).transpose(0, 1)                  # (B, T, di)


def _ssm_inputs(p: dict, xi: torch.Tensor, cfg: ModelConfig) -> tuple:
    """(B, C, dt) in f32 and A from the conv's output ``xi``."""
    ds = cfg.mamba_d_state
    bcdt = xi @ p["w_bcdt"]
    Bm = bcdt[..., :ds].float()
    Cm = bcdt[..., ds:2 * ds].float()
    dt = softplus(bcdt[..., -1:].float() + p["dt_bias"])
    return Bm, Cm, dt, -torch.exp(p["A_log"])


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 256) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D)."""
    B, T, D = x.shape
    di = cfg.mamba_expand * D
    up = x @ p["w_in"]
    xi, gate = up[..., :di], up[..., di:]
    xi = silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
    Bm, Cm, dt, A = _ssm_inputs(p, xi, cfg)
    xf = xi.float()
    y = _selective_scan(xf, dt, A, Bm, Cm, divisor_chunk(T, chunk))
    y = y + xf * p["D_skip"]
    y = y.to(x.dtype) * silu(gate)
    return y @ p["w_out"]


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> dict:
    """h (B, di, ds) in f32 and the conv tail (B, dc - 1, di) in ``dtype``,
    zeros."""
    di = cfg.mamba_expand * cfg.d_model
    return {"h": torch.zeros((batch, di, cfg.mamba_d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di),
                                dtype=dtype, device=device)}


def mamba_decode_step(p: dict, x: torch.Tensor, state: dict,
                      cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """x (B, 1, D) -> (B, 1, D).  Writes the new h and conv tail into
    ``state``'s tensors and returns them."""
    B, _, D = x.shape
    di = cfg.mamba_expand * D
    up = x[:, 0] @ p["w_in"]
    xi, gate = up[..., :di], up[..., di:]
    # causal conv over [conv_tail ; x_t]
    window = torch.cat([state["conv"], xi[:, None]], dim=1)   # (B, dc, di)
    xi = silu(torch.einsum("bci,ci->bi", window, p["conv_w"]) + p["conv_b"])
    Bm, Cm, dt, A = _ssm_inputs(p, xi, cfg)
    decay = torch.exp(dt[..., None] * A)                      # (B, di, ds)
    xf = xi.float()
    h = state["h"].mul_(decay).add_((dt * xf)[..., None] * Bm[:, None, :])
    state["conv"].copy_(window[:, 1:])
    y = torch.einsum("bis,bs->bi", h, Cm) + xf * p["D_skip"]
    y = y.to(x.dtype) * silu(gate)
    return (y @ p["w_out"]).reshape(B, 1, D), state
