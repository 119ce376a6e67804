"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, sequential), interleaved mLSTM:sLSTM = 7:1.

mLSTM's full-sequence form is chunkwise parallel: within a chunk the
stabilized quadratic form, across chunks a (d_k x d_v) matrix-state carry
in f32, O(T * c) instead of O(T^2).  Decode carries that state: O(1) a
step.  The decode steps write the new state into the state tensors they
are given (the values of the JAX package's functional update) and return
them.

Dtypes follow the JAX package's promotion: q, k and v stay in the
activation dtype, a product of one of them with an f32 tensor is f32, and
the gates, stabilizers and carries are f32.
"""
from __future__ import annotations

import torch
from torch import nn

from ..dist.ctx import constrain
from .attention import score_scale
from .config import ModelConfig
from .layers import (TreeModule, divisor_chunk, init_dense_, init_normal_,
                     log_sigmoid, param, reshape, rmsnorm, silu)

NEG_INF = -1e30


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.dot`` of two dtypes: both cast to the promoted one first."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


class MLSTMParams(TreeModule):
    """w_in [D, 2di] (up-projection: x and gate), wq, wk and wv [H, dh, dh]
    (per-head block-diagonal), w_i and w_f [di, H] and b_i, b_f [H] (the
    gates, f32), w_out [di, D] and norm_scale [di] (f32)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D = cfg.d_model
        di = int(cfg.mlstm_proj_factor * D)
        H = cfg.n_heads
        dh = di // H
        f32 = torch.float32
        self.w_in = param((D, 2 * di), dtype, device)
        self.wq = param((H, dh, dh), dtype, device)
        self.wk = param((H, dh, dh), dtype, device)
        self.wv = param((H, dh, dh), dtype, device)
        self.w_i = param((di, H), f32, device)
        self.w_f = param((di, H), f32, device)
        self.b_i = param((H,), f32, device)
        self.b_f = param((H,), f32, device)
        self.w_out = param((di, D), dtype, device)
        self.norm_scale = param((di,), f32, device)

    def init(self, generator: torch.Generator) -> None:
        dh = self.wq.shape[-1]
        init_dense_(self.w_in, generator)
        for w in (self.wq, self.wk, self.wv):
            init_normal_(w, (1.0 / dh) ** 0.5, generator)
        init_dense_(self.w_i, generator)
        init_dense_(self.w_f, generator)
        nn.init.zeros_(self.b_i)
        nn.init.constant_(self.b_f, 3.0)            # open forget gates
        init_dense_(self.w_out, generator)
        nn.init.ones_(self.norm_scale)


def _mlstm_chunk_scan(q, k, v, log_i, log_f, chunk: int) -> torch.Tensor:
    """Chunkwise stabilized mLSTM.

    q/k/v: (B, H, T, dk|dv); log_i/log_f: (B, H, T) log input/forget gates;
    ``chunk`` divides T.  Returns (B, H, T, dv) in q's dtype."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    nc = T // chunk
    qc = reshape(q, B, H, nc, chunk, dk)
    kc = reshape(k, B, H, nc, chunk, dk)
    vc = reshape(v, B, H, nc, chunk, dv)
    ic = reshape(log_i, B, H, nc, chunk)
    csum_f = torch.cumsum(reshape(log_f, B, H, nc, chunk), dim=-1)
    f_total = csum_f[..., -1]                             # (B, H, nc)
    upper = ~torch.ones(chunk, chunk, dtype=torch.bool,
                        device=q.device).tril()
    scale = score_scale(dk, q.dtype)

    C = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, dk), dtype=torch.float32, device=q.device)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    outs = []
    for c in range(nc):
        qt, kt, vt = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        it, ft_cum, ftot = ic[:, :, c], csum_f[:, :, c], f_total[:, :, c]
        b = ft_cum + m[..., None]                         # log scale of carry
        # intra-chunk log weights  D_ts = cumF_t - cumF_s + i_s  (s <= t)
        lw = ft_cum[..., :, None] - ft_cum[..., None, :] + it[..., None, :]
        lw = lw.masked_fill(upper, float("-inf"))
        m_new = torch.maximum(b, lw.amax(dim=-1))         # stabilizer per t
        w_intra = torch.exp(lw - m_new[..., None])        # (B, H, c, c)
        scale_inter = torch.exp(b - m_new)                # (B, H, c)

        qs = qt / scale
        attn = torch.einsum("bhtk,bhsk->bhts", qs, kt) * w_intra
        qf, kf, vf = qs.float(), kt.float(), vt.float()
        intra = torch.einsum("bhts,bhsv->bhtv", attn, vf)
        inter = torch.einsum("bhtk,bhkv->bhtv", qf, C) * scale_inter[..., None]
        dot_n = attn.sum(-1) + torch.einsum("bhtk,bhk->bht", qf, n) \
            * scale_inter
        denom = torch.maximum(dot_n.abs(), torch.exp(-m_new))
        outs.append((intra + inter) / denom[..., None])

        # carry: C' = exp(ftot + m - m') C + sum_s exp(ftot - cumF_s + i_s
        # - m') k_s v_s^T
        lw_new = ftot[..., None] - ft_cum + it
        m_next = torch.maximum(ftot + m, lw_new.amax(dim=-1))
        decay_old = torch.exp(ftot + m - m_next)
        w_new = torch.exp(lw_new - m_next[..., None])     # (B, H, c)
        C = decay_old[..., None, None] * C + torch.einsum(
            "bhsk,bhsv->bhkv", w_new[..., None] * kf, vf)
        n = decay_old[..., None] * n + torch.einsum("bhs,bhsk->bhk", w_new,
                                                    kf)
        m = m_next
    return reshape(torch.stack(outs, dim=2), B, H, T, dv).to(q.dtype)


def _gates(p: dict, xin: torch.Tensor) -> tuple:
    """log input and forget gates in f32, (..., H)."""
    xf = xin.float()
    return (log_sigmoid(mm(xf, p["w_i"]) + p["b_i"]),
            log_sigmoid(mm(xf, p["w_f"]) + p["b_f"]))


def mlstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 64) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D)."""
    B, T, D = x.shape
    H = cfg.n_heads
    di = int(cfg.mlstm_proj_factor * D)
    up = x @ p["w_in"]
    xin, gate = up[..., :di], up[..., di:]
    xh = reshape(xin, B, T, H, di // H)
    q = torch.einsum("bthd,hde->bhte", xh, p["wq"])
    k = torch.einsum("bthd,hde->bhte", xh, p["wk"])
    v = torch.einsum("bthd,hde->bhte", xh, p["wv"])
    log_i, log_f = (g.transpose(1, 2) for g in _gates(p, xin))
    h = _mlstm_chunk_scan(q, k, v, log_i, log_f, divisor_chunk(T, chunk))
    h = reshape(h.transpose(1, 2), B, T, di)
    h = rmsnorm(h, p["norm_scale"])
    h = h * silu(gate)
    return h @ p["w_out"]


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """The f32 recurrent state: C (B, H, dh, dh), n (B, H, dh), m (B, H)."""
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    H = cfg.n_heads
    dh = di // H
    f32 = torch.float32
    return {"C": torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, H, dh), dtype=f32, device=device),
            "m": torch.full((batch, H), NEG_INF, dtype=f32, device=device)}


def mlstm_decode_step(p: dict, x: torch.Tensor, state: dict,
                      cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One recurrent step: x (B, 1, D) -> (B, 1, D).  Writes the new C, n
    and m into ``state``'s tensors and returns them."""
    B, _, D = x.shape
    H = cfg.n_heads
    di = int(cfg.mlstm_proj_factor * D)
    dh = di // H
    up = x[:, 0] @ p["w_in"]
    xin, gate = up[..., :di], up[..., di:]
    xh = reshape(xin, B, H, dh)
    q = torch.einsum("bhd,hde->bhe", xh, p["wq"]) / score_scale(dh, xh.dtype)
    k = torch.einsum("bhd,hde->bhe", xh, p["wk"])
    v = torch.einsum("bhd,hde->bhe", xh, p["wv"])
    log_i, log_f = _gates(p, xin)                         # (B, H)

    m_new = torch.maximum(log_f + state["m"], log_i)
    decay = torch.exp(log_f + state["m"] - m_new)
    inp = torch.exp(log_i - m_new)
    C = state["C"].mul_(decay[..., None, None]).add_(
        inp[..., None, None] * k[..., :, None] * v[..., None, :])
    n = state["n"].mul_(decay[..., None]).add_(inp[..., None] * k)
    state["m"].copy_(m_new)
    qf = q.float()
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs(),
                        torch.exp(-m_new))[..., None]
    h = reshape(num / den, B, di)
    h = rmsnorm(h, p["norm_scale"])
    h = h * silu(gate)
    return reshape(mm(h, p["w_out"]), B, 1, D).to(x.dtype), state


# --------------------------------------------------------------------------- #
# sLSTM: scalar memory, inherently sequential
# --------------------------------------------------------------------------- #


class SLSTMParams(TreeModule):
    """w_z, w_i, w_f, w_o [D, D] (input projections), r_z [D, D] (the
    recurrent weights) and the f32 biases b_z, b_i, b_f, b_o [D]."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D = cfg.d_model
        for name in ("w_z", "w_i", "w_f", "w_o", "r_z"):
            setattr(self, name, param((D, D), dtype, device))
        for name in ("b_z", "b_i", "b_f", "b_o"):
            setattr(self, name, param((D,), torch.float32, device))

    def init(self, generator: torch.Generator) -> None:
        for w in (self.w_z, self.w_i, self.w_f, self.w_o, self.r_z):
            init_dense_(w, generator)
        with torch.no_grad():
            self.r_z.mul_(0.1)
        nn.init.zeros_(self.b_z)
        nn.init.zeros_(self.b_i)
        nn.init.constant_(self.b_f, 3.0)
        nn.init.zeros_(self.b_o)


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """c, n, h (B, D) zeros and m (B, D) at -1e30, f32, each its own
    tensor (decode writes them in place)."""
    D = cfg.d_model
    f32 = torch.float32
    out = {k: torch.zeros((batch, D), dtype=f32, device=device)
           for k in ("c", "n", "h")}
    out["m"] = torch.full((batch, D), NEG_INF, dtype=f32, device=device)
    return out


def _slstm_projections(p: dict, x: torch.Tensor) -> tuple:
    """The four x-dependent pre-activations in f32, hoisted out of the
    recurrence: only the h @ r_z matvec stays inside it."""
    return tuple((x @ p[w]).float() + p[b]
                 for w, b in (("w_z", "b_z"), ("w_i", "b_i"),
                              ("w_f", "b_f"), ("w_o", "b_o")))


def slstm_step(p: dict, pre: tuple, st: dict) -> tuple[dict, torch.Tensor]:
    """One stabilized sLSTM step from precomputed projections."""
    zx, ix, fx, ox = pre
    h_prev = st["h"].to(p["r_z"].dtype)
    z = torch.tanh(zx + (h_prev @ p["r_z"]).float())
    log_i = ix
    log_f = log_sigmoid(fx)
    o = torch.sigmoid(ox)
    m_new = torch.maximum(log_f + st["m"], log_i)
    keep = torch.exp(log_f + st["m"] - m_new)
    put = torch.exp(log_i - m_new)
    c = keep * st["c"] + put * z
    n = keep * st["n"] + put
    h = o * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}, h


def slstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D); projections batched, recurrence looped."""
    B, T, D = x.shape
    st = init_slstm_state(cfg, B, x.device)
    pres = [constrain(a, "residual") for a in _slstm_projections(p, x)]
    hs = []
    for t in range(T):
        st, h = slstm_step(p, tuple(a[:, t] for a in pres), st)
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype)


def slstm_decode_step(p: dict, x: torch.Tensor, state: dict,
                      cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """x (B, 1, D) -> (B, 1, D); writes the new state into ``state``."""
    st2, h = slstm_step(p, _slstm_projections(p, x[:, 0]), state)
    for name, t in st2.items():
        state[name].copy_(t)
    return h[:, None].to(x.dtype), state
