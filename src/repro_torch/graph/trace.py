"""Tracers: lower a model config into a ``KernelGraph`` of ISAMIR kernels.

``trace_block`` lowers one decoder block — its QKV / attention-matmul / FFN
GEMM skeleton — into per-kernel nodes:

    x ──> q_h/k_h/v_h GEMMs ──> s_h = q_h·k_hᵀ ──> scale+relu ──> a_h = s_h·v_h
      └──────────────┐             (per head h)                     │
                     v                                              v
    y1 = x + Σ_h a_h·wo_h   ──>  g = relu(y1·w_gate), u = y1·w_up,
                                 y2 = y1 + (g + u)·w_down

Two deliberate liberties keep the **bit-exactness contract** with the
torch reference (``repro_torch.models.traceable``) machine-checkable:

  * the attention score scaling is the canonical ``1/sqrt(head_dim)`` with
    ``head_dim`` a power of four, expressed as a chain of ``halve`` ops —
    multiplication by a power of two is *exact* in binary floating point;
  * the usual transcendental nonlinearities (softmax, silu) are replaced by
    ``relu`` attention weights and an additive relu-gated FFN — every traced
    op (dot products, adds, max, powers of two) is exact over the dyadic
    values ``block_inputs`` generates, so any summation order — the ISAMIR
    interpreter's, the card's K1 launches', or the reference's — produces
    the same bits, as long as every value stays below 2^24
    (``EXACT_F32_BOUND``).

Norms are folded away (a norm-free block, cf. residual-scaled NFNet-style
stacks); the graph tier cares about the GEMM + epilogue dataflow, not the
pointwise statistics.

``trace_gru_chain`` is the stretch tracer: an unrolled GRU layer whose
steps all share one kernel program — the extreme artifact-dedupe case
(N nodes, 1 compile).

``trace_whisper_decoder`` lowers whisper's decoder stack as published:
biased projections, causal self-attention and cross-attention over the
encoder's frames with a softmax, a two-GEMM GELU MLP and the head tied to
the token embedding, in the same per-head decomposition.  Its values are
not dyadic, so it is held to a float64 reference
(``models.whisper_block_reference``) within rounding, not bit for bit.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from ..core import kernels_ir as K
from ..core.ir import Program, ProgramBuilder
from ..models.config import ModelConfig
from .ir import GraphBuilder, GraphError, KernelGraph

#: past this magnitude an f32 node-boundary cast starts rounding integer
#: values, and the cross-backend bit-exactness argument no longer holds.
EXACT_F32_BOUND = float(1 << 24)


# --------------------------------------------------------------------------- #
# Kernel program builders (deterministically named by shape, so identical
# shapes share a fingerprint and the artifact cache dedupes them)
# --------------------------------------------------------------------------- #


def matmul_nt(m: int, n: int, k: int) -> Program:
    """C[i,j] += A[i,d] * B[j,d] — GEMM against a transposed RHS, the shape
    of attention scores q·kᵀ.  Maps onto ``mxu.matmul`` with a permuted
    buffer dim map."""
    pb = ProgramBuilder(f"matmul_nt_{m}x{n}x{k}")
    i, j, d = pb.axes(i=m, j=n, k=k)
    A = pb.buffer("A", (m, k))
    B = pb.buffer("B", (n, k))
    C = pb.buffer("C", (m, n))
    t = pb.temp("tmp", (m, n, k))
    pb.stmt(t[i, j, d], ":=", A[i, d])
    pb.stmt(t[i, j, d], "*=", B[j, d])
    pb.stmt(C[i, j], "+=", t[i, j, d])
    pb.output("C")
    return pb.build()


def ew_add(m: int, n: int) -> Program:
    """O = X + Y (elementwise)."""
    pb = ProgramBuilder(f"ewadd_{m}x{n}")
    a, b = pb.axes(a=m, b=n)
    X = pb.buffer("X", (m, n))
    Y = pb.buffer("Y", (m, n))
    O = pb.buffer("O", (m, n))
    pb.stmt(O[a, b], ":=", X[a, b])
    pb.stmt(O[a, b], "+=", Y[a, b])
    pb.output("O")
    return pb.build()


def ew_relu(m: int, n: int) -> Program:
    """O = relu(X)."""
    pb = ProgramBuilder(f"ewrelu_{m}x{n}")
    a, b = pb.axes(a=m, b=n)
    X = pb.buffer("X", (m, n))
    O = pb.buffer("O", (m, n))
    pb.apply(O[a, b], "relu", X[a, b])
    pb.output("O")
    return pb.build()


def ew_scale_relu(m: int, n: int, halvings: int) -> Program:
    """O = relu(X * 2**-halvings) — the attention-score epilogue."""
    pb = ProgramBuilder(f"scalerelu_{m}x{n}_h{halvings}")
    a, b = pb.axes(a=m, b=n)
    X = pb.buffer("X", (m, n))
    O = pb.buffer("O", (m, n))
    pb.apply(O[a, b], "halve", X[a, b])
    for _ in range(halvings - 1):
        pb.apply(O[a, b], "halve", O[a, b])
    pb.apply(O[a, b], "relu", O[a, b])
    pb.output("O")
    return pb.build()


# --------------------------------------------------------------------------- #
# The transformer-block tracer
# --------------------------------------------------------------------------- #


def trace_block(cfg: ModelConfig, seq_len: int = 8,
                name: str | None = None) -> KernelGraph:
    """Lower one decoder block of ``cfg`` into a ``KernelGraph``.

    Deterministic: the same (config dims, seq_len) produce the same graph
    fingerprint.  Requires ``cfg.hd`` (head dim) to be a power of four so the
    1/sqrt(head_dim) score scale is a whole number of halvings.
    """
    T, D, H, F = seq_len, cfg.d_model, cfg.n_heads, cfg.d_ff
    Dh = cfg.hd
    if H * Dh != D:
        raise GraphError(f"trace_block needs n_heads*head_dim == d_model "
                         f"(got {H}*{Dh} != {D})")
    halvings = (Dh.bit_length() - 1) // 2
    if 4 ** halvings != Dh:
        raise GraphError(f"trace_block needs a power-of-4 head_dim for the "
                         f"exact 1/sqrt(d) scale (got {Dh})")

    gb = GraphBuilder(name or f"block_{cfg.name}_T{T}")
    x = gb.tensor("x", (T, D), is_input=True)
    for h in range(H):
        for w in ("wq", "wk", "wv"):
            gb.tensor(f"{w}{h}", (D, Dh), is_input=True)
        gb.tensor(f"wo{h}", (Dh, D), is_input=True)
    for w, shape in (("w_gate", (D, F)), ("w_up", (D, F)),
                     ("w_down", (F, D))):
        gb.tensor(w, shape, is_input=True)

    def gemm(out: str, shape, prog: Program, a: str, b: str) -> str:
        gb.tensor(out, shape)
        gb.node(out, prog, {"A": a, "B": b}, {"C": out}, kind="gemm")
        return out

    def add(out: str, a: str, b: str) -> str:
        shape = gb.tensors[a].shape
        gb.tensor(out, shape)
        gb.node(out, ew_add(*shape), {"X": a, "Y": b}, {"O": out},
                kind="elementwise")
        return out

    mm_qkv = K.matmul(T, Dh, D)       # x (T,D) @ w (D,Dh)
    mm_scores = matmul_nt(T, T, Dh)   # q (T,Dh) @ k (T,Dh)^T
    mm_av = K.matmul(T, Dh, T)        # s (T,T) @ v (T,Dh)
    mm_proj = K.matmul(T, D, Dh)      # a (T,Dh) @ wo (Dh,D)
    mm_ffn = K.matmul(T, F, D)        # y1 (T,D) @ w (D,F)
    mm_down = K.matmul(T, D, F)       # h (T,F) @ w_down (F,D)

    # -- attention: per-head GEMM chains, head outputs summed ---------------
    projs = []
    for h in range(H):
        q = gemm(f"q{h}", (T, Dh), mm_qkv, x, f"wq{h}")
        k = gemm(f"k{h}", (T, Dh), mm_qkv, x, f"wk{h}")
        v = gemm(f"v{h}", (T, Dh), mm_qkv, x, f"wv{h}")
        sraw = gemm(f"sraw{h}", (T, T), mm_scores, q, k)
        s = gb.tensor(f"s{h}", (T, T))
        gb.node(f"s{h}", ew_scale_relu(T, T, halvings), {"X": sraw},
                {"O": s}, kind="elementwise")
        a = gemm(f"a{h}", (T, Dh), mm_av, s, v)
        projs.append(gemm(f"p{h}", (T, D), mm_proj, a, f"wo{h}"))
    attn = projs[0]
    for h in range(1, H):
        attn = add(f"attn{h}" if h < H - 1 else "attn", attn, projs[h])
    y1 = add("y1", x, attn)

    # -- FFN: additive relu gate (g + u, exact — no value-squaring mul) -----
    graw = gemm("graw", (T, F), mm_ffn, y1, "w_gate")
    g = gb.tensor("g", (T, F))
    gb.node("g", ew_relu(T, F), {"X": graw}, {"O": g}, kind="elementwise")
    u = gemm("u", (T, F), mm_ffn, y1, "w_up")
    hid = add("hid", g, u)
    o = gemm("o", (T, D), mm_down, hid, "w_down")
    add("y2", y1, o)
    gb.output("y2")
    return gb.build()


def trace_gru_chain(batch: int = 4, hidden: int = 16, inp: int = 16,
                    steps: int = 4) -> KernelGraph:
    """Stretch tracer: an unrolled GRU layer.  Every step is the *same*
    kernel program — N nodes, one compile (the dedupe-extreme case)."""
    gb = GraphBuilder(f"gru_{batch}x{hidden}x{inp}_s{steps}")
    prog = K.gru_cell(batch, hidden, inp)
    weights = {}
    for b in prog.buffers:
        if b.temp or b.name in ("X", "H", "Hout"):
            continue
        weights[b.name] = gb.tensor(b.name, b.shape, is_input=True)
    h = gb.tensor("h0", (batch, hidden), is_input=True)
    for t in range(steps):
        x = gb.tensor(f"x{t}", (batch, inp), is_input=True)
        nxt = gb.tensor(f"h{t + 1}", (batch, hidden))
        gb.node(f"step{t}", prog, {"X": x, "H": h, **weights},
                {"Hout": nxt}, kind="gemm")
        h = nxt
    gb.output(h)
    return gb.build()


# --------------------------------------------------------------------------- #
# The whisper decoder tracer
# --------------------------------------------------------------------------- #

#: GELU's tanh form: 0.5 x (1 + tanh(GELU_C (x + GELU_A x^3)))
GELU_A = 0.044715
GELU_C = math.sqrt(2.0 / math.pi)

_HEAD_WEIGHT = re.compile(r"^(l\d+\.(?:sa|ca)\.)(w[qkvo]|b[qv])(\d+)$")


def matmul_bias(m: int, n: int, k: int) -> Program:
    """C[i,j] = sum_k A[i,k] B[k,j] + bias[j] — a biased projection: the
    GEMM triple, then the bias, as K2's instruction (``fused.matmul_bias``)
    reads."""
    pb = ProgramBuilder(f"matmul_bias_{m}x{n}x{k}")
    i, j, d = pb.axes(i=m, j=n, k=k)
    A = pb.buffer("A", (m, k))
    B = pb.buffer("B", (k, n))
    bias = pb.buffer("bias", (n,))
    C = pb.buffer("C", (m, n))
    t = pb.temp("tmp", (m, n, k))
    pb.stmt(t[i, j, d], ":=", A[i, d])
    pb.stmt(t[i, j, d], "*=", B[d, j])
    pb.stmt(C[i, j], "+=", t[i, j, d])
    pb.stmt(C[i, j], "+=", bias[j])
    pb.output("C")
    return pb.build()


def matmul_scale_rows(m: int, n: int, k: int) -> Program:
    """C[i,j] = r[i] * sum_k A[i,k] B[k,j] — attention's weighted sum of the
    values, each row scaled by its softmax's reciprocal row sum ``r``."""
    pb = ProgramBuilder(f"matmul_scalerows_{m}x{n}x{k}")
    i, j, d = pb.axes(i=m, j=n, k=k)
    A = pb.buffer("A", (m, k))
    B = pb.buffer("B", (k, n))
    r = pb.buffer("r", (m,))
    C = pb.buffer("C", (m, n))
    t = pb.temp("tmp", (m, n, k))
    pb.stmt(t[i, j, d], ":=", A[i, d])
    pb.stmt(t[i, j, d], "*=", B[d, j])
    pb.stmt(C[i, j], "+=", t[i, j, d])
    pb.stmt(C[i, j], "*=", r[i])
    pb.output("C")
    return pb.build()


def ew_scale_exp(m: int, n: int, halvings: int, masked: bool) -> Program:
    """O = exp(X * 2**-halvings), times the 0/1 mask M when ``masked`` —
    the scores' epilogue: the scale as exact halvings, the softmax's
    exponent, and the causal mask after it."""
    pb = ProgramBuilder(f"scaleexp_{m}x{n}_h{halvings}"
                        + ("_masked" if masked else ""))
    a, b = pb.axes(a=m, b=n)
    X = pb.buffer("X", (m, n))
    O = pb.buffer("O", (m, n))
    pb.apply(O[a, b], "halve", X[a, b])
    for _ in range(halvings - 1):
        pb.apply(O[a, b], "halve", O[a, b])
    pb.apply(O[a, b], "exp", O[a, b])
    if masked:
        M = pb.buffer("M", (m, n))
        pb.stmt(O[a, b], "*=", M[a, b])
    pb.output("O")
    return pb.build()


def row_recip_sum(m: int, n: int) -> Program:
    """r[i] = 1 / sum_j E[i,j] — the softmax's reciprocal row sums."""
    pb = ProgramBuilder(f"rowrecipsum_{m}x{n}")
    i, j = pb.axes(i=m, j=n)
    E = pb.buffer("E", (m, n))
    r = pb.buffer("r", (m,))
    pb.stmt(r[i], "+=", E[i, j])
    pb.apply(r[i], "recip", r[i])
    pb.output("r")
    return pb.build()


def ew_gelu_tanh(m: int, n: int) -> Program:
    """O = 0.5 X (1 + tanh(KC (X + KA X^3))) — GELU's tanh form, with its
    constants as inputs filled with ``GELU_A`` (KA) and ``GELU_C`` (KC).
    X is read once, into O, as epilogue fusion needs; the temp V keeps it."""
    pb = ProgramBuilder(f"gelutanh_{m}x{n}")
    a, b = pb.axes(a=m, b=n)
    X = pb.buffer("X", (m, n))
    KA = pb.buffer("KA", (m, n))
    KC = pb.buffer("KC", (m, n))
    O = pb.buffer("O", (m, n))
    V = pb.temp("V", (m, n))
    pb.stmt(O[a, b], ":=", X[a, b])
    pb.stmt(V[a, b], ":=", O[a, b])
    pb.stmt(O[a, b], "*=", V[a, b])            # x^2
    pb.stmt(O[a, b], "*=", KA[a, b])
    pb.apply(O[a, b], "neg", O[a, b])
    pb.apply(O[a, b], "sub_from_one", O[a, b])  # 1 + a x^2
    pb.stmt(O[a, b], "*=", V[a, b])            # x + a x^3
    pb.stmt(O[a, b], "*=", KC[a, b])
    pb.apply(O[a, b], "tanh", O[a, b])
    pb.apply(O[a, b], "neg", O[a, b])
    pb.apply(O[a, b], "sub_from_one", O[a, b])  # 1 + tanh(.)
    pb.stmt(O[a, b], "*=", V[a, b])
    pb.apply(O[a, b], "halve", O[a, b])
    pb.output("O")
    return pb.build()


def trace_whisper_decoder(cfg: ModelConfig, seq_len: int, frames: int,
                          n_layers: int, name: str | None = None
                          ) -> KernelGraph:
    """Lower ``n_layers`` of whisper's decoder and its tied output head into
    one ``KernelGraph``, per head as ``trace_block`` does.

    Inputs: ``x`` (the embedded prompt, ``seq_len`` x d_model), ``xa`` (the
    encoder's ``frames`` x d_model output), the causal 0/1 ``mask``, the
    GELU constants ``gelu_a`` / ``gelu_c`` (``whisper_inputs`` fills all
    four), each layer's per-head weights ``l{l}.sa.wq{h}`` (d_model x
    head_dim), ``bq{h}``, ``wk{h}`` (no bias, as published), ``wv{h}``,
    ``bv{h}``, ``wo{h}`` (head_dim x d_model) and ``bo``, the same under
    ``l{l}.ca.``, the MLP's ``l{l}.fc1``, ``b1``, ``fc2``, ``b2``, and the
    token embedding ``emb`` (vocab x d_model).  Outputs: the last layer's
    stream ``x{n_layers}`` and the ``logits`` (seq_len x vocab).

    Per layer: causal self-attention, cross-attention over ``xa``, the
    GELU MLP, each added to the stream.  A head's scores s = q kᵀ / sqrt(hd)
    (whisper's hd^-1/4 on q and on k, as exact halvings of s) go through
    exp, the mask (self-attention), the reciprocal row sum and the values'
    GEMM, whose rows that sum scales; the heads' output projections are
    summed with the bias ``bo`` on head 0's.

    What ISAMIR cannot write is left out or rewritten, and the reference
    shares it: the three LayerNorms of a layer and the one before the head
    are left out (no ``rsqrt``); GELU takes its tanh form (no ``erf``).
    Beyond what ISAMIR forces, the softmax does not subtract its row max:
    a row vector broadcast over the frames is one scheduled call per frame,
    and the scheduler's overlap checks grow with the square of the calls
    (42 s to compile a 448 x 1500 softmax with it, 0.01 s without).  So its
    f32 values grow with the scores: exp of a scaled score past 88.72 is
    inf, and the values' GEMM sums exp(s) times v in f32; the stack stays
    finite while those stay below f32's max, where the reference's softmax
    does throughout.
    """
    T, S, D, H, F = seq_len, frames, cfg.d_model, cfg.n_heads, cfg.d_ff
    Dh, V = cfg.hd, cfg.vocab_size
    if H * Dh != D:
        raise GraphError(f"trace_whisper_decoder needs n_heads*head_dim == "
                         f"d_model (got {H}*{Dh} != {D})")
    halvings = (Dh.bit_length() - 1) // 2
    if 4 ** halvings != Dh:
        raise GraphError(f"trace_whisper_decoder needs a power-of-4 head_dim "
                         f"for the exact 1/sqrt(d) scale (got {Dh})")
    if n_layers < 1:
        raise GraphError(f"trace_whisper_decoder needs a layer, not "
                         f"{n_layers}")

    gb = GraphBuilder(name or f"whisper_{cfg.name}_L{n_layers}_T{T}_S{S}")
    for t, shape in (("x", (T, D)), ("xa", (S, D)), ("mask", (T, T)),
                     ("gelu_a", (T, F)), ("gelu_c", (T, F))):
        gb.tensor(t, shape, is_input=True)

    def weight(t: str, shape) -> str:
        return gb.tensor(t, shape, is_input=True)

    def node(out: str, shape, prog: Program, ins: dict, kind: str) -> str:
        gb.tensor(out, shape)
        gb.node(out, prog, ins, {prog.outputs[0]: out}, kind=kind)
        return out

    def add(out: str, a: str, b: str) -> str:
        shape = gb.tensors[a].shape
        return node(out, shape, ew_add(*shape), {"X": a, "Y": b},
                    "elementwise")

    def attention(pre: str, xq: str, xkv: str, skv: int, masked: bool,
                  out: str) -> str:
        attn = None
        for h in range(H):
            q = node(f"{pre}q{h}", (T, Dh), matmul_bias(T, Dh, D),
                     {"A": xq, "B": weight(f"{pre}wq{h}", (D, Dh)),
                      "bias": weight(f"{pre}bq{h}", (Dh,))}, "gemm")
            k = node(f"{pre}k{h}", (skv, Dh), K.matmul(skv, Dh, D),
                     {"A": xkv, "B": weight(f"{pre}wk{h}", (D, Dh))}, "gemm")
            v = node(f"{pre}v{h}", (skv, Dh), matmul_bias(skv, Dh, D),
                     {"A": xkv, "B": weight(f"{pre}wv{h}", (D, Dh)),
                      "bias": weight(f"{pre}bv{h}", (Dh,))}, "gemm")
            sraw = node(f"{pre}sraw{h}", (T, skv), matmul_nt(T, skv, Dh),
                        {"A": q, "B": k}, "gemm")
            e = node(f"{pre}e{h}", (T, skv),
                     ew_scale_exp(T, skv, halvings, masked),
                     {"X": sraw, **({"M": "mask"} if masked else {})},
                     "elementwise")
            r = node(f"{pre}r{h}", (T,), row_recip_sum(T, skv), {"E": e},
                     "reduce")
            a = node(f"{pre}a{h}", (T, Dh), matmul_scale_rows(T, Dh, skv),
                     {"A": e, "B": v, "r": r}, "gemm")
            wo = {"A": a, "B": weight(f"{pre}wo{h}", (Dh, D))}
            if h == 0:
                p = node(f"{pre}p{h}", (T, D), matmul_bias(T, D, Dh),
                         {**wo, "bias": weight(f"{pre}bo", (D,))}, "gemm")
            else:
                p = node(f"{pre}p{h}", (T, D), K.matmul(T, D, Dh), wo,
                         "gemm")
            attn = p if attn is None else add(
                f"{pre}attn{h}" if h < H - 1 else f"{pre}attn", attn, p)
        return add(out, xq, attn)

    x = "x"
    for l in range(n_layers):
        pre = f"l{l}."
        y1 = attention(pre + "sa.", x, x, T, True, pre + "y1")
        y2 = attention(pre + "ca.", y1, "xa", S, False, pre + "y2")
        f = node(pre + "f", (T, F), matmul_bias(T, F, D),
                 {"A": y2, "B": weight(pre + "fc1", (D, F)),
                  "bias": weight(pre + "b1", (F,))}, "gemm")
        g = node(pre + "g", (T, F), ew_gelu_tanh(T, F),
                 {"X": f, "KA": "gelu_a", "KC": "gelu_c"}, "elementwise")
        o = node(pre + "o", (T, D), matmul_bias(T, D, F),
                 {"A": g, "B": weight(pre + "fc2", (F, D)),
                  "bias": weight(pre + "b2", (D,))}, "gemm")
        x = add(f"x{l + 1}", y2, o)
    node("logits", (T, V), matmul_nt(T, V, D),
         {"A": x, "B": weight("emb", (V, D))}, "gemm")
    gb.output(x, "logits")
    return gb.build()


def whisper_inputs(g: KernelGraph, params: dict, x: torch.Tensor,
                   xa: torch.Tensor) -> dict[str, torch.Tensor]:
    """The inputs of a ``trace_whisper_decoder`` graph, on ``x``'s device:
    ``x`` and ``xa`` as given, the causal mask and the GELU constants, and
    each weight from whisper's full-width parameters ``params``
    (``models.whisper_block_reference.init_params``' names: ``l{l}.sa.wq``
    d_model x d_model and so on): a head's columns of wq, wk, wv, its
    elements of bq, bv and its rows of wo, each made contiguous.  A name
    ``params`` holds is taken as it is, so the inputs of one graph serve as
    the ``params`` of another with the same widths and layers."""
    dev = x.device
    T, F = g.tensors["gelu_a"].shape
    out = {"x": x, "xa": xa,
           "mask": torch.tril(torch.ones(T, T, device=dev)),
           "gelu_a": torch.full((T, F), GELU_A, device=dev),
           "gelu_c": torch.full((T, F), GELU_C, device=dev)}
    for t in g.inputs:
        if t in out:
            continue
        if t in params:
            out[t] = params[t]
            continue
        m = _HEAD_WEIGHT.match(t)
        if m is None:
            raise GraphError(f"no parameter for graph input {t!r}")
        pre, kind, h = m.group(1), m.group(2), int(m.group(3))
        full = params[pre + kind]
        shape = g.tensors[t].shape
        dh = shape[0] if kind in ("wo", "bq", "bv") else shape[1]
        rows = slice(h * dh, (h + 1) * dh)
        part = full[:, rows] if kind[0] == "w" and kind != "wo" else full[rows]
        out[t] = part.contiguous()
    return out


# --------------------------------------------------------------------------- #
# Oracle inputs
# --------------------------------------------------------------------------- #


def block_inputs(g: KernelGraph, seed: int = 0) -> dict[str, np.ndarray]:
    """Ternary {-1, 0, +1} inputs for every graph input tensor.

    Integer-valued data keeps every traced op exact in any summation order
    (see module docstring); the fixed seed keeps the whole contract
    deterministic.  ``assert_exactness_bound`` checks the magnitudes stay
    inside the f32-exact range."""
    rng = np.random.default_rng(seed)
    return {t: rng.integers(-1, 2, g.tensors[t].shape).astype(np.float32)
            for t in g.inputs}


def assert_exactness_bound(env: dict[str, np.ndarray]) -> float:
    """Guard: every tensor must stay below 2**24 so f32 node-boundary casts
    are exact.  Returns the observed max magnitude."""
    worst = 0.0
    for t, arr in env.items():
        m = float(np.max(np.abs(arr))) if arr.size else 0.0
        if m >= EXACT_F32_BOUND:
            raise GraphError(
                f"tensor {t} magnitude {m:.3e} exceeds the f32-exact bound "
                f"2^24; shrink the traced shapes or sparsify the inputs")
        worst = max(worst, m)
    return worst
