"""Canned deep-learning kernels in ISAMIR (the paper's haystack programs).

These mirror the paper's evaluation set (Section 6.1): matrix multiplication,
1D convolution, 2D convolution, depthwise convolution, separable-depthwise
convolution (Listing 3), and the GRU cell — plus attention score/value einsums
used by the model zoo.
"""
from __future__ import annotations

from .ir import Program, ProgramBuilder


def matmul(m: int, n: int, k: int, accumulate: bool = True) -> Program:
    pb = ProgramBuilder(f"matmul_{m}x{n}x{k}")
    i, j, kk = pb.axes(i=m, j=n, k=k)
    A = pb.buffer("A", (m, k))
    B = pb.buffer("B", (k, n))
    C = pb.buffer("C", (m, n))
    t = pb.temp("tmp", (m, n, k))
    pb.stmt(t[i, j, kk], ":=", A[i, kk])
    pb.stmt(t[i, j, kk], "*=", B[kk, j])
    pb.stmt(C[i, j], "+=", t[i, j, kk])
    pb.output("C")
    return pb.build()


def conv1d(batch: int, width: int, kw: int, cin: int, cout: int) -> Program:
    """Listing 5: C[i,x,ko] += A[i,x+d,ki] * B[d,ki,ko]."""
    pb = ProgramBuilder("conv1d")
    i, x, d, ki, ko = pb.axes(i=batch, x=width, d=kw, ki=cin, ko=cout)
    A = pb.buffer("A", (batch, width + kw - 1, cin))
    B = pb.buffer("B", (kw, cin, cout))
    C = pb.buffer("C", (batch, width, cout))
    t = pb.temp("tmp", (batch, width, kw, cin, cout))
    pb.stmt(t[i, x, d, ki, ko], ":=", A[i, x + d, ki])
    pb.stmt(t[i, x, d, ki, ko], "*=", B[d, ki, ko])
    pb.stmt(C[i, x, ko], "+=", t[i, x, d, ki, ko])
    pb.output("C")
    return pb.build()


def conv2d(batch: int, h: int, w: int, kh: int, kw: int, cin: int, cout: int,
           stride: int = 1) -> Program:
    pb = ProgramBuilder("conv2d")
    b, y, x, dy, dx, ki, ko = pb.axes(b=batch, y=h, x=w, dy=kh, dx=kw,
                                      ci=cin, co=cout)
    H, W = stride * (h - 1) + kh, stride * (w - 1) + kw
    A = pb.buffer("A", (batch, H, W, cin))
    Wt = pb.buffer("W", (kh, kw, cin, cout))
    C = pb.buffer("C", (batch, h, w, cout))
    t = pb.temp("tmp", (batch, h, w, kh, kw, cin, cout))
    pb.stmt(t[b, y, x, dy, dx, ki, ko], ":=", A[b, stride * y + dy, stride * x + dx, ki])
    pb.stmt(t[b, y, x, dy, dx, ki, ko], "*=", Wt[dy, dx, ki, ko])
    pb.stmt(C[b, y, x, ko], "+=", t[b, y, x, dy, dx, ki, ko])
    pb.output("C")
    return pb.build()


def depthwise_conv2d(batch: int, h: int, w: int, kh: int, kw: int, c: int,
                     stride: int = 1) -> Program:
    """Depthwise convolution: channels are not mixed."""
    pb = ProgramBuilder("depthwise_conv2d")
    b, y, x, dy, dx, q = pb.axes(b=batch, y=h, x=w, dy=kh, dx=kw, q=c)
    H, W = stride * (h - 1) + kh, stride * (w - 1) + kw
    A = pb.buffer("A", (batch, H, W, c))
    D = pb.buffer("D", (kh, kw, c))
    C = pb.buffer("C", (batch, h, w, c))
    t = pb.temp("tmp", (batch, h, w, kh, kw, c))
    pb.stmt(t[b, y, x, dy, dx, q], ":=", A[b, stride * y + dy, stride * x + dx, q])
    pb.stmt(t[b, y, x, dy, dx, q], "*=", D[dy, dx, q])
    pb.stmt(C[b, y, x, q], "+=", t[b, y, x, dy, dx, q])
    pb.output("C")
    return pb.build()


def separable_depthwise_conv(batch: int, h: int, w: int, kh: int, kw: int,
                             cin: int, mult: int, cout: int,
                             stride: int = 1) -> Program:
    """Paper Listing 3: C[b,i,j,k] += A[b,s*i+di,s*j+dj,q] * D[di,dj,q,r]
    * P[c*q+r, k] — a depthwise stage fused with a pointwise projection.

    Direct mapping fails (two multiplications feed one reduction); the
    factor-out-of-reduction transformation (transforms.py) splits it into a
    depthwise reduction followed by a matmul-mappable pointwise reduction.
    """
    pb = ProgramBuilder("separable_depthwise_conv")
    b, i, j, k, di, dj, q, r = pb.axes(b=batch, i=h, j=w, k=cout, di=kh,
                                       dj=kw, q=cin, r=mult)
    H, W = stride * (h - 1) + kh, stride * (w - 1) + kw
    A = pb.buffer("A", (batch, H, W, cin))
    D = pb.buffer("D", (kh, kw, cin, mult))
    P = pb.buffer("P", (cin * mult, cout))
    C = pb.buffer("C", (batch, h, w, cout))
    t = pb.temp("tmp", (batch, h, w, cout, kh, kw, cin, mult))
    pb.stmt(t[b, i, j, k, di, dj, q, r], ":=",
            A[b, stride * i + di, stride * j + dj, q])
    pb.stmt(t[b, i, j, k, di, dj, q, r], "*=", D[di, dj, q, r])
    pb.stmt(t[b, i, j, k, di, dj, q, r], "*=", P[mult * q + r, k])
    pb.stmt(C[b, i, j, k], "+=", t[b, i, j, k, di, dj, q, r])
    pb.output("C")
    return pb.build()


def gru_cell(batch: int, hidden: int, inp: int) -> Program:
    """One GRU step in three-operand ISAMIR (paper Section 6.2.2).

        r = sigmoid(x Wr + h Ur + br)
        z = sigmoid(x Wz + h Uz + bz)
        n = tanh(x Wn + r * (h Un + bn_h) + bn_x)
        h' = (1 - z) * n + z * h

    The mapper extracts the six GEMMs onto ``mxu.matmul`` (or the fused
    matmul+bias+activation needles) and the gates onto VPU instructions.
    """
    pb = ProgramBuilder("gru_cell")
    b, o, e = pb.axes(b=batch, o=hidden, e=inp)
    h2 = pb.axis("h2", hidden)  # reduction axis over previous hidden
    X = pb.buffer("X", (batch, inp))
    H = pb.buffer("H", (batch, hidden))
    Wr = pb.buffer("Wr", (inp, hidden))
    Ur = pb.buffer("Ur", (hidden, hidden))
    Wz = pb.buffer("Wz", (inp, hidden))
    Uz = pb.buffer("Uz", (hidden, hidden))
    Wn = pb.buffer("Wn", (inp, hidden))
    Un = pb.buffer("Un", (hidden, hidden))
    br = pb.buffer("br", (hidden,))
    bz = pb.buffer("bz", (hidden,))
    bnx = pb.buffer("bnx", (hidden,))
    bnh = pb.buffer("bnh", (hidden,))
    R = pb.buffer("R", (batch, hidden), temp=True)
    Z = pb.buffer("Z", (batch, hidden), temp=True)
    Nb = pb.buffer("N", (batch, hidden), temp=True)
    Hn = pb.buffer("Hn", (batch, hidden), temp=True)  # h-side of n gate
    OneMZ = pb.buffer("OneMZ", (batch, hidden), temp=True)
    ZH = pb.buffer("ZH", (batch, hidden), temp=True)
    Hout = pb.buffer("Hout", (batch, hidden))
    t1 = pb.temp("t1", (batch, hidden, inp))
    t2 = pb.temp("t2", (batch, hidden, hidden))
    t3 = pb.temp("t3", (batch, hidden, inp))
    t4 = pb.temp("t4", (batch, hidden, hidden))
    t5 = pb.temp("t5", (batch, hidden, inp))
    t6 = pb.temp("t6", (batch, hidden, hidden))

    # r gate
    pb.stmt(t1[b, o, e], ":=", X[b, e])
    pb.stmt(t1[b, o, e], "*=", Wr[e, o])
    pb.stmt(R[b, o], "+=", t1[b, o, e])
    pb.stmt(t2[b, o, h2], ":=", H[b, h2])
    pb.stmt(t2[b, o, h2], "*=", Ur[h2, o])
    pb.stmt(R[b, o], "+=", t2[b, o, h2])
    pb.stmt(R[b, o], "+=", br[o])
    pb.apply(R[b, o], "sigmoid", R[b, o])
    # z gate
    pb.stmt(t3[b, o, e], ":=", X[b, e])
    pb.stmt(t3[b, o, e], "*=", Wz[e, o])
    pb.stmt(Z[b, o], "+=", t3[b, o, e])
    pb.stmt(t4[b, o, h2], ":=", H[b, h2])
    pb.stmt(t4[b, o, h2], "*=", Uz[h2, o])
    pb.stmt(Z[b, o], "+=", t4[b, o, h2])
    pb.stmt(Z[b, o], "+=", bz[o])
    pb.apply(Z[b, o], "sigmoid", Z[b, o])
    # n gate
    pb.stmt(t6[b, o, h2], ":=", H[b, h2])
    pb.stmt(t6[b, o, h2], "*=", Un[h2, o])
    pb.stmt(Hn[b, o], "+=", t6[b, o, h2])
    pb.stmt(Hn[b, o], "+=", bnh[o])
    pb.stmt(Hn[b, o], "*=", R[b, o])
    pb.stmt(t5[b, o, e], ":=", X[b, e])
    pb.stmt(t5[b, o, e], "*=", Wn[e, o])
    pb.stmt(Nb[b, o], "+=", t5[b, o, e])
    pb.stmt(Nb[b, o], "+=", Hn[b, o])
    pb.stmt(Nb[b, o], "+=", bnx[o])
    pb.apply(Nb[b, o], "tanh", Nb[b, o])
    # h' = (1 - z) * n + z * h
    pb.apply(OneMZ[b, o], "sub_from_one", Z[b, o])
    pb.stmt(OneMZ[b, o], "*=", Nb[b, o])
    pb.stmt(ZH[b, o], ":=", Z[b, o])
    pb.stmt(ZH[b, o], "*=", H[b, o])
    pb.stmt(Hout[b, o], ":=", OneMZ[b, o])
    pb.stmt(Hout[b, o], "+=", ZH[b, o])
    pb.output("Hout")
    return pb.build()


def attention_scores(batch: int, heads: int, q_len: int, k_len: int,
                     head_dim: int) -> Program:
    """S[b,h,i,j] += Q[b,h,i,d] * K[b,h,j,d] — the QK^T einsum."""
    pb = ProgramBuilder("attention_scores")
    b, h, i, j, d = pb.axes(b=batch, h=heads, i=q_len, j=k_len, d=head_dim)
    Q = pb.buffer("Q", (batch, heads, q_len, head_dim))
    K = pb.buffer("K", (batch, heads, k_len, head_dim))
    S = pb.buffer("S", (batch, heads, q_len, k_len))
    t = pb.temp("tmp", (batch, heads, q_len, k_len, head_dim))
    pb.stmt(t[b, h, i, j, d], ":=", Q[b, h, i, d])
    pb.stmt(t[b, h, i, j, d], "*=", K[b, h, j, d])
    pb.stmt(S[b, h, i, j], "+=", t[b, h, i, j, d])
    pb.output("S")
    return pb.build()


def mlp_gate(batch: int, d_model: int, d_ff: int) -> Program:
    """SwiGLU up-projection pair: G = sigmoid(X Wg) * (X Wu) — exercises
    instruction selection across matmul + elementwise needles."""
    pb = ProgramBuilder("mlp_gate")
    b, f, e = pb.axes(b=batch, f=d_ff, e=d_model)
    X = pb.buffer("X", (batch, d_model))
    Wg = pb.buffer("Wg", (d_model, d_ff))
    Wu = pb.buffer("Wu", (d_model, d_ff))
    G = pb.buffer("G", (batch, d_ff), temp=True)
    U = pb.buffer("U", (batch, d_ff), temp=True)
    Y = pb.buffer("Y", (batch, d_ff))
    t1 = pb.temp("t1", (batch, d_ff, d_model))
    t2 = pb.temp("t2", (batch, d_ff, d_model))
    pb.stmt(t1[b, f, e], ":=", X[b, e])
    pb.stmt(t1[b, f, e], "*=", Wg[e, f])
    pb.stmt(G[b, f], "+=", t1[b, f, e])
    pb.apply(G[b, f], "sigmoid", G[b, f])
    pb.stmt(t2[b, f, e], ":=", X[b, e])
    pb.stmt(t2[b, f, e], "*=", Wu[e, f])
    pb.stmt(U[b, f], "+=", t2[b, f, e])
    pb.stmt(Y[b, f], ":=", G[b, f])
    pb.stmt(Y[b, f], "*=", U[b, f])
    pb.output("Y")
    return pb.build()
