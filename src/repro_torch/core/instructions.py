"""The target "ISA" described in ISAMIR needles (paper Sections 2.1, 5).

On TPU the instruction set exposed to the mapper is:

  * ``mxu.matmul``    — C[i,j] += A[i,k] * B[k,j]   (the MXU; any extents —
                         the scheduler tiles macro-calls into 128^3 hardware
                         tiles, see scheduler.py)
  * ``mxu.matmul128`` — fixed 128x128x128 variant (the literal hardware tile)
  * ``vpu.dot``       — c[] += a[k] * b[k]
  * ``vpu.mul`` / ``vpu.add`` / ``vpu.sub`` / ``vpu.max`` — elementwise binary
  * ``vpu.<fn>``      — elementwise unary (sigmoid, tanh, relu, exp, ...)
  * ``vpu.reduce_sum`` / ``vpu.reduce_max`` — axis reduction
  * ``fused.matmul_bias_<fn>`` — fused GEMM + bias + activation (the paper's
                         "fused instructions" used by instruction selection)

Needle axis size 0 = symbolic (matches any extent).  Buffers named abstractly;
the mapper's buffer map ties them to real haystack buffers.
"""
from __future__ import annotations

from functools import lru_cache

from .ir import Program, ProgramBuilder, UNARY_FNS


@lru_cache(maxsize=None)
def mxu_matmul(ti: int = 0, tj: int = 0, tk: int = 0, name: str = "mxu.matmul") -> Program:
    pb = ProgramBuilder(name)
    i, j, k = pb.axis("i", ti), pb.axis("j", tj), pb.axis("k", tk)
    A = pb.buffer("A", (ti, tk))
    B = pb.buffer("B", (tk, tj))
    C = pb.buffer("C", (ti, tj))
    t = pb.temp("t", (ti, tj, tk))
    pb.stmt(t[i, j, k], ":=", A[i, k])
    pb.stmt(t[i, j, k], "*=", B[k, j])
    pb.stmt(C[i, j], "+=", t[i, j, k])
    return pb.build()


@lru_cache(maxsize=None)
def mxu_matmul128() -> Program:
    return mxu_matmul(128, 128, 128, name="mxu.matmul128")


@lru_cache(maxsize=None)
def vpu_dot() -> Program:
    pb = ProgramBuilder("vpu.dot")
    k = pb.axis("k", 0)
    a = pb.buffer("a", (0,))
    b = pb.buffer("b", (0,))
    c = pb.buffer("c", (1,))
    t = pb.temp("t", (0,))
    pb.stmt(t[k], ":=", a[k])
    pb.stmt(t[k], "*=", b[k])
    pb.stmt(c[0], "+=", t[k])
    return pb.build()


@lru_cache(maxsize=None)
def vpu_binary(op: str) -> Program:
    """Elementwise binary: y <op>= x over one symbolic axis."""
    sym = {"*=": "mul", "+=": "add", "-=": "sub", "max=": "max"}[op]
    pb = ProgramBuilder(f"vpu.{sym}")
    e = pb.axis("e", 0)
    x = pb.buffer("x", (0,))
    y = pb.buffer("y", (0,))
    pb.stmt(y[e], op, x[e])
    return pb.build()


@lru_cache(maxsize=None)
def vpu_unary(fn: str) -> Program:
    assert fn in UNARY_FNS, fn
    pb = ProgramBuilder(f"vpu.{fn}")
    e = pb.axis("e", 0)
    x = pb.buffer("x", (0,))
    y = pb.buffer("y", (0,))
    pb.apply(y[e], fn, x[e])
    return pb.build()


@lru_cache(maxsize=None)
def vpu_unary_inplace(fn: str) -> Program:
    """In-place elementwise unary: x := fn(x) (operands may alias on the VPU)."""
    assert fn in UNARY_FNS, fn
    pb = ProgramBuilder(f"vpu.{fn}_")
    e = pb.axis("e", 0)
    x = pb.buffer("x", (0,))
    pb.apply(x[e], fn, x[e])
    return pb.build()


@lru_cache(maxsize=None)
def vpu_copy() -> Program:
    pb = ProgramBuilder("vpu.copy")
    e = pb.axis("e", 0)
    x = pb.buffer("x", (0,))
    y = pb.buffer("y", (0,))
    pb.stmt(y[e], ":=", x[e])
    return pb.build()


@lru_cache(maxsize=None)
def vpu_reduce(op: str = "+=") -> Program:
    sym = {"+=": "reduce_sum", "max=": "reduce_max"}[op]
    pb = ProgramBuilder(f"vpu.{sym}")
    r = pb.axis("r", 0)
    x = pb.buffer("x", (0,))
    y = pb.buffer("y", (1,))
    pb.stmt(y[0], op, x[r])
    return pb.build()


@lru_cache(maxsize=None)
def fused_matmul_bias(fn: str = "") -> Program:
    """C[i,j] = fn(sum_k A[i,k] B[k,j] + b[j]) — a fused MXU+VPU instruction.

    Exposing this lets instruction selection (Section 2.4) choose between one
    fused call and three separate calls; the GRU benchmark exercises it.
    """
    name = "fused.matmul_bias" + (f"_{fn}" if fn else "")
    pb = ProgramBuilder(name)
    i, j, k = pb.axis("i", 0), pb.axis("j", 0), pb.axis("k", 0)
    A = pb.buffer("A", (0, 0))
    B = pb.buffer("B", (0, 0))
    b = pb.buffer("b", (0,))
    C = pb.buffer("C", (0, 0))
    t = pb.temp("t", (0, 0, 0))
    pb.stmt(t[i, j, k], ":=", A[i, k])
    pb.stmt(t[i, j, k], "*=", B[k, j])
    pb.stmt(C[i, j], "+=", t[i, j, k])
    pb.stmt(C[i, j], "+=", b[j])
    if fn:
        pb.apply(C[i, j], fn, C[i, j])
    return pb.build()


def tpu_isa(include_fused: bool = True) -> list[Program]:
    """The full needle library, most-specific (largest) first — instruction
    selection prefers needles that cover more statements per call."""
    isa: list[Program] = []
    if include_fused:
        isa += [fused_matmul_bias("sigmoid"), fused_matmul_bias("tanh"),
                fused_matmul_bias()]
    isa.append(mxu_matmul())
    isa.append(vpu_dot())
    isa += [vpu_binary(op) for op in ("*=", "+=", "-=", "max=")]
    for fn in ("sigmoid", "tanh", "relu", "exp", "sub_from_one", "neg",
               "recip", "halve"):
        isa.append(vpu_unary(fn))
        isa.append(vpu_unary_inplace(fn))
    isa += [vpu_reduce("+="), vpu_reduce("max="), vpu_copy()]
    return isa


def is_elementwise(needle_name: str) -> bool:
    """Pure elementwise VPU instructions (no reductions): their calls can be
    coalesced across outer axes by the scheduler (one big vector op instead
    of one call per outer point)."""
    if not needle_name.startswith("vpu."):
        return False
    return needle_name != "vpu.dot" and not needle_name.startswith("vpu.reduce")
