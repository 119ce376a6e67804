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
"""
from __future__ import annotations

import numpy as np

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
