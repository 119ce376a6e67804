"""ISAMIR — the paper's intermediate representation (Section 2.1).

Both the program to execute (the "haystack") and every hardware instruction
(a "needle") are expressed in the same IR:

  * a set of *loop axes* with integer extents (the ``forall`` domain — the IR is
    iteration-order invariant, so the axis set carries no ordering semantics),
  * a set of *buffers* (named, shaped, dtyped tensors),
  * a list of three-operand *statements*, each performing exactly one operation
    ``lhs <op>= rhs`` where both sides are affine *accesses* into buffers.

Each access is represented by an integer *access matrix* with one row per
buffer dimension and one column per loop axis, plus a constant offset vector —
exactly the polyhedral-style representation the paper uses for mapping
(Section 2.2).  Statements are executed (for analysis semantics) one at a time
over their full iteration domain.

This module also provides a NumPy interpreter used as the semantic oracle for
mapper / transformation correctness tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np

# --------------------------------------------------------------------------- #
# Operations
# --------------------------------------------------------------------------- #

#: Binary accumulate / assign operations, in the paper's ``<op>=`` notation.
OPS = (":=", "+=", "*=", "-=", "max=")

#: Unary elementwise functions supported by APPLY statements (``lhs := f(rhs)``).
UNARY_FNS: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "tanh": np.tanh,
    "relu": lambda x: np.maximum(x, 0.0),
    "exp": np.exp,
    "neg": np.negative,
    "recip": lambda x: 1.0 / x,
    "sub_from_one": lambda x: 1.0 - x,  # common in gates: (1 - z)
    "halve": lambda x: 0.5 * x,  # exact in binary fp: attention 1/sqrt(d)
    "id": lambda x: x,
}


class IRError(ValueError):
    """Raised on malformed ISAMIR constructs."""


# --------------------------------------------------------------------------- #
# Core node types
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Axis:
    """A loop axis: name + extent.  Extent ``0`` means symbolic (needles)."""

    name: str
    size: int = 0

    @property
    def symbolic(self) -> bool:
        return self.size == 0


@dataclass(frozen=True)
class Buffer:
    """A named tensor.  ``temp`` buffers exist only for 3-operand analysis and
    are removed / replaced before execution (paper Section 2.1)."""

    name: str
    shape: tuple[int, ...]
    dtype: str = "f32"
    temp: bool = False

    @property
    def rank(self) -> int:
        return len(self.shape)


@dataclass(frozen=True)
class Access:
    """Affine access into ``buffer``: index of dim ``d`` at iteration point
    ``x`` (a vector over program axes, in program axis order) is

        ``index[d] = sum_a matrix[d][a] * x[a] + offset[d]``.
    """

    buffer: str
    matrix: tuple[tuple[int, ...], ...]  # rows = buffer dims, cols = prog axes
    offset: tuple[int, ...] = ()

    def __post_init__(self):
        if not self.offset:
            object.__setattr__(self, "offset", (0,) * len(self.matrix))
        if len(self.offset) != len(self.matrix):
            raise IRError(f"offset rank {len(self.offset)} != matrix rows {len(self.matrix)}")

    @property
    def rank(self) -> int:
        return len(self.matrix)

    def np_matrix(self) -> np.ndarray:
        return np.array(self.matrix, dtype=np.int64).reshape(self.rank, -1)

    def axes_used(self, axis_names: Sequence[str]) -> frozenset[str]:
        """Names of program axes with any nonzero coefficient."""
        used = set()
        for row in self.matrix:
            for a, coeff in enumerate(row):
                if coeff != 0:
                    used.add(axis_names[a])
        return frozenset(used)


@dataclass(frozen=True)
class Statement:
    """``lhs <op>= rhs``; or, for ``op='apply'``, ``lhs := fn(rhs)``."""

    op: str
    lhs: Access
    rhs: Access
    fn: str = ""

    def __post_init__(self):
        if self.op == "apply":
            if self.fn not in UNARY_FNS:
                raise IRError(f"unknown unary fn {self.fn!r}")
        elif self.op not in OPS:
            raise IRError(f"unknown op {self.op!r}")

    @property
    def kind(self) -> str:
        """Op discriminator used for statement matching (op + fn)."""
        return f"apply:{self.fn}" if self.op == "apply" else self.op


@dataclass(frozen=True)
class Program:
    """An ISAMIR program: axes, buffers, and an ordered statement list.

    ``outputs`` names the buffers whose final contents are the program result
    (everything else — in particular temps — is scratch).
    """

    name: str
    axes: tuple[Axis, ...]
    buffers: tuple[Buffer, ...]
    statements: tuple[Statement, ...]
    outputs: tuple[str, ...] = ()

    # -- construction helpers ------------------------------------------------
    def __post_init__(self):
        names = [a.name for a in self.axes]
        if len(set(names)) != len(names):
            raise IRError(f"duplicate axis names in {names}")
        bnames = [b.name for b in self.buffers]
        if len(set(bnames)) != len(bnames):
            raise IRError(f"duplicate buffer names in {bnames}")
        ncols = len(self.axes)
        for s in self.statements:
            for acc in (s.lhs, s.rhs):
                if acc.buffer not in bnames:
                    raise IRError(f"access to unknown buffer {acc.buffer!r}")
                buf = self.buffer(acc.buffer)
                if acc.rank != buf.rank:
                    raise IRError(
                        f"access rank {acc.rank} != buffer {buf.name} rank {buf.rank}")
                for row in acc.matrix:
                    if len(row) != ncols:
                        raise IRError(
                            f"access matrix row width {len(row)} != n axes {ncols}")
        if not self.outputs:
            non_temp_written = []
            for s in self.statements:
                b = self.buffer(s.lhs.buffer)
                if not b.temp and b.name not in non_temp_written:
                    non_temp_written.append(b.name)
            object.__setattr__(self, "outputs", tuple(non_temp_written))

    # -- lookups --------------------------------------------------------------
    def axis(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(name)

    def axis_index(self, name: str) -> int:
        for i, a in enumerate(self.axes):
            if a.name == name:
                return i
        raise KeyError(name)

    def buffer(self, name: str) -> Buffer:
        for b in self.buffers:
            if b.name == name:
                return b
        raise KeyError(name)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    # -- derived properties ----------------------------------------------------
    def reads(self, stmt: Statement) -> tuple[str, ...]:
        """Buffers read by a statement (accumulating ops also read the lhs)."""
        if stmt.op in (":=", "apply"):
            return (stmt.rhs.buffer,)
        return (stmt.rhs.buffer, stmt.lhs.buffer)

    def writes(self, stmt: Statement) -> str:
        return stmt.lhs.buffer

    def signature(self) -> str:
        """Canonical structural string (used for search-space dedup)."""
        parts = [
            ",".join(f"{a.name}:{a.size}" for a in self.axes),
            ",".join(f"{b.name}:{b.shape}:{int(b.temp)}" for b in self.buffers),
        ]
        for s in self.statements:
            parts.append(
                f"{s.kind}|{s.lhs.buffer}{s.lhs.matrix}{s.lhs.offset}"
                f"|{s.rhs.buffer}{s.rhs.matrix}{s.rhs.offset}")
        return ";".join(parts)

    # -- pretty printing --------------------------------------------------------
    def _fmt_access(self, acc: Access) -> str:
        names = self.axis_names
        idxs = []
        for row, off in zip(acc.matrix, acc.offset):
            terms = []
            for a, coeff in enumerate(row):
                if coeff == 1:
                    terms.append(names[a])
                elif coeff != 0:
                    terms.append(f"{coeff}*{names[a]}")
            if off:
                terms.append(str(off))
            idxs.append("+".join(terms) if terms else "0")
        return f"{acc.buffer}[" + "][".join(idxs) + "]"

    def pretty(self) -> str:
        hdr = ", ".join("{}<{}".format(a.name, a.size or "?") for a in self.axes)
        lines = ["forall " + hdr + " {"]
        for s in self.statements:
            lhs, rhs = self._fmt_access(s.lhs), self._fmt_access(s.rhs)
            if s.op == "apply":
                lines.append(f"  {lhs} := {s.fn}({rhs});")
            else:
                lines.append(f"  {lhs} {s.op} {rhs};")
        lines.append("}")
        return "\n".join(lines)

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return self.pretty()


# --------------------------------------------------------------------------- #
# Builder — ergonomic front-end for writing ISAMIR programs in tests/configs
# --------------------------------------------------------------------------- #


class ProgramBuilder:
    """Small DSL::

        pb = ProgramBuilder("matmul")
        i, j, k = pb.axes(i=64, j=64, k=64)
        A, B, C = pb.buffer("A", (64, 64)), ...
        t = pb.temp("tmp", (64, 64, 64))
        pb.stmt(t[i, j, k], ":=", A[i, k])
        pb.stmt(t[i, j, k], "*=", B[k, j])
        pb.stmt(C[i, j], "+=", t[i, j, k])
        prog = pb.build()

    Index expressions are linear combinations of axis handles plus ints, e.g.
    ``A[2 * i + d + 1, k]``.
    """

    def __init__(self, name: str):
        self.name = name
        self._axes: list[Axis] = []
        self._buffers: list[Buffer] = []
        self._stmts: list[Statement] = []
        self._outputs: list[str] = []

    # axes ---------------------------------------------------------------
    def axis(self, name: str, size: int = 0) -> "AxisExpr":
        self._axes.append(Axis(name, size))
        return AxisExpr({name: 1}, 0)

    def axes(self, **sizes: int) -> tuple["AxisExpr", ...]:
        return tuple(self.axis(n, s) for n, s in sizes.items())

    # buffers --------------------------------------------------------------
    def buffer(self, name: str, shape: tuple[int, ...], dtype: str = "f32",
               temp: bool = False) -> "BufferHandle":
        self._buffers.append(Buffer(name, tuple(shape), dtype, temp))
        return BufferHandle(self, name)

    def temp(self, name: str, shape: tuple[int, ...], dtype: str = "f32") -> "BufferHandle":
        return self.buffer(name, shape, dtype, temp=True)

    def output(self, *names: str) -> None:
        self._outputs.extend(names)

    # statements --------------------------------------------------------------
    def stmt(self, lhs: "AccessExpr", op: str, rhs: "AccessExpr", fn: str = "") -> None:
        self._stmts.append(Statement(op, lhs.to_access(self), rhs.to_access(self), fn))

    def apply(self, lhs: "AccessExpr", fn: str, rhs: "AccessExpr") -> None:
        self.stmt(lhs, "apply", rhs, fn=fn)

    # finalize ------------------------------------------------------------------
    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self._axes)

    def build(self) -> Program:
        return Program(self.name, tuple(self._axes), tuple(self._buffers),
                       tuple(self._stmts), tuple(self._outputs))


@dataclass(frozen=True)
class AxisExpr:
    """Linear combination of axes + constant, e.g. ``2*i + d + 1``."""

    coeffs: Mapping[str, int]
    const: int = 0

    def __add__(self, other):
        if isinstance(other, int):
            return AxisExpr(self.coeffs, self.const + other)
        merged = dict(self.coeffs)
        for k, v in other.coeffs.items():
            merged[k] = merged.get(k, 0) + v
        return AxisExpr(merged, self.const + other.const)

    __radd__ = __add__

    def __mul__(self, c: int):
        return AxisExpr({k: v * c for k, v in self.coeffs.items()}, self.const * c)

    __rmul__ = __mul__


@dataclass(frozen=True)
class BufferHandle:
    pb: "ProgramBuilder"
    name: str

    def __getitem__(self, idx) -> "AccessExpr":
        if not isinstance(idx, tuple):
            idx = (idx,)
        exprs = []
        for e in idx:
            if isinstance(e, int):
                exprs.append(AxisExpr({}, e))
            else:
                exprs.append(e)
        return AccessExpr(self.name, tuple(exprs))


@dataclass(frozen=True)
class AccessExpr:
    buffer: str
    indices: tuple[AxisExpr, ...]

    def to_access(self, pb: ProgramBuilder) -> Access:
        names = pb.axis_names
        matrix, offset = [], []
        for e in self.indices:
            matrix.append(tuple(e.coeffs.get(n, 0) for n in names))
            offset.append(e.const)
        return Access(self.buffer, tuple(matrix), tuple(offset))


# --------------------------------------------------------------------------- #
# Interpreter — the semantic oracle
# --------------------------------------------------------------------------- #


def _np_dtype(dtype: str):
    return {"f32": np.float32, "f64": np.float64, "bf16": np.float32,
            "i32": np.int32}.get(dtype, np.float32)


def interpret(prog: Program, inputs: Mapping[str, np.ndarray],
              accumulate_f64: bool = True,
              cast_outputs: bool = True) -> dict[str, np.ndarray]:
    """Execute ``prog`` per ISAMIR analysis semantics: each statement runs to
    completion over the full iteration domain before the next begins.

    Buffers not present in ``inputs`` are zero-initialised.  Returns the final
    contents of ``prog.outputs``, cast to each buffer's dtype unless
    ``cast_outputs`` is false (the executor replays needle programs *inside*
    a larger f64 computation and must not round intermediate accumulators —
    only the whole program's final outputs are cast, like the oracle).
    """
    for a in prog.axes:
        if a.symbolic:
            raise IRError(f"cannot interpret program with symbolic axis {a.name}")

    # Materialize buffers (work in f64 to keep the oracle exact-ish).
    bufs: dict[str, np.ndarray] = {}
    for b in prog.buffers:
        if b.name in inputs:
            arr = np.asarray(inputs[b.name], dtype=np.float64)
            if arr.shape != b.shape:
                raise IRError(f"input {b.name} shape {arr.shape} != {b.shape}")
            bufs[b.name] = arr.copy()
        else:
            bufs[b.name] = np.zeros(b.shape, dtype=np.float64)

    # Per the paper, statements range over *loop domains*: a statement's
    # domain is the set of axes its accesses actually use (iterating unused
    # axes would double-count `+=` contributions).
    def stmt_grids(s: Statement) -> np.ndarray:
        used = [a for ai, a in enumerate(prog.axes)
                if any(row[ai] for acc in (s.lhs, s.rhs) for row in acc.matrix)]
        sizes = tuple(a.size for a in used) or (1,)
        cols = [prog.axis_index(a.name) for a in used]
        sub = np.indices(sizes).reshape(len(sizes), -1)
        full = np.zeros((len(prog.axes), sub.shape[1]), dtype=np.int64)
        for r, c in enumerate(cols):
            full[c] = sub[r]
        return full

    def gather_indices(acc: Access, grids: np.ndarray) -> tuple[np.ndarray, ...]:
        mat = acc.np_matrix()  # (rank, n_axes)
        off = np.array(acc.offset, dtype=np.int64)[:, None]
        idx = mat @ grids + off  # (rank, n_points)
        return tuple(idx)

    for s in prog.statements:
        grids = stmt_grids(s)
        li = gather_indices(s.lhs, grids)
        ri = gather_indices(s.rhs, grids)
        rvals = bufs[s.rhs.buffer][ri]
        out = bufs[s.lhs.buffer]
        if s.op == ":=":
            out[li] = rvals
        elif s.op == "apply":
            out[li] = UNARY_FNS[s.fn](rvals)
        elif s.op == "+=":
            np.add.at(out, li, rvals)
        elif s.op == "-=":
            np.subtract.at(out, li, rvals)
        elif s.op == "*=":
            np.multiply.at(out, li, rvals)
        elif s.op == "max=":
            np.maximum.at(out, li, rvals)
        else:  # pragma: no cover
            raise IRError(f"unhandled op {s.op}")

    if not cast_outputs:
        return {name: bufs[name] for name in prog.outputs}
    return {name: bufs[name].astype(_np_dtype(prog.buffer(name).dtype))
            for name in prog.outputs}


def random_inputs(prog: Program, rng: np.random.Generator,
                  lo: float = -1.0, hi: float = 1.0) -> dict[str, np.ndarray]:
    """Random inputs for every non-temp buffer that is read before written."""
    written: set[str] = set()
    needed: set[str] = set()
    for s in prog.statements:
        for r in prog.reads(s):
            if r not in written and not prog.buffer(r).temp:
                needed.add(r)
        written.add(s.lhs.buffer)
    return {n: rng.uniform(lo, hi, size=prog.buffer(n).shape).astype(np.float64)
            for n in sorted(needed)}
