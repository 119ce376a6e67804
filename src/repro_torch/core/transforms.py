"""IR transformations + the non-deterministic mapping search (Section 2.3).

When the deterministic mapper fails, its structured failures drive the choice
of algebraic transformation to apply next.  The canonical example is the
separable-depthwise convolution (paper Listing 3): the reduction chain
contains *two* multiplications, so no matmul window is extractable; the
**factor-out-of-reduction** transformation splits the single reduction into a
depthwise reduction followed by a pointwise (matmul-mappable) reduction.

Transformations are semantics-preserving (the hypothesis property tests check
them against the NumPy oracle), modulo buffer-view adaptation exposed through
``adapt_inputs`` / ``adapt_outputs``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np

from .ir import Access, Axis, Buffer, IRError, Program, Statement
from .mapper import MapFailure, MapResult, map_program

# --------------------------------------------------------------------------- #
# Transform interface
# --------------------------------------------------------------------------- #


class Transform:
    """A semantics-preserving rewrite of an ISAMIR program."""

    name: str = "transform"

    def apply(self, prog: Program) -> Program:  # pragma: no cover - interface
        raise NotImplementedError

    # Buffer-shape adaptation (identity for most transforms).
    def adapt_inputs(self, inputs: dict) -> dict:
        return inputs

    def adapt_outputs(self, outputs: dict) -> dict:
        return outputs

    def __repr__(self) -> str:
        return self.name


def _identity_access(buffer: str, axes: list[str], axis_names: tuple[str, ...]) -> Access:
    mat = tuple(tuple(1 if an == ax else 0 for an in axis_names) for ax in axes)
    return Access(buffer, mat)


def _axes_used(prog: Program, acc: Access) -> list[str]:
    """Axes with nonzero coefficient, in program axis order."""
    return [an for ai, an in enumerate(prog.axis_names)
            if any(row[ai] for row in acc.matrix)]


# --------------------------------------------------------------------------- #
# Factor-out-of-reduction (the separable-depthwise enabler)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ReductionChain:
    """Statements ``t := A; t *= B1; ...; t *= Bm; C += t`` (m >= 1)."""

    start: int            # index of the ':=' statement
    muls: tuple[int, ...] # indices of the '*=' statements
    end: int              # index of the '+=' statement
    temp: str             # the chain temporary


def find_reduction_chains(prog: Program, min_muls: int = 1) -> list[ReductionChain]:
    chains = []
    i = 0
    stmts = prog.statements
    while i < len(stmts):
        s = stmts[i]
        if s.op == ":=" and prog.buffer(s.lhs.buffer).temp:
            t = s.lhs.buffer
            j = i + 1
            muls = []
            while j < len(stmts) and stmts[j].op == "*=" and stmts[j].lhs.buffer == t:
                muls.append(j)
                j += 1
            if (len(muls) >= min_muls and j < len(stmts)
                    and stmts[j].op == "+=" and stmts[j].rhs.buffer == t):
                # the temp must not be used anywhere else
                uses = [k for k, s2 in enumerate(stmts)
                        if t in prog.reads(s2) or prog.writes(s2) == t]
                if set(uses) <= set([i, j] + muls):
                    chains.append(ReductionChain(i, tuple(muls), j, t))
                    i = j + 1
                    continue
        i += 1
    return chains


@dataclass(frozen=True, repr=False)
class FactorReduction(Transform):
    """Rewrite  ``C += A * B1 * ... * Bm``  (reduction R) into

        U  += A * B1 * ... * B_{f-1} * B_{f+1} * ... * Bm   (reduction R1)
        C  += U * B_f                                        (reduction R2)

    where R1 = R \\ axes(B_f) — the algebraic fact ``sum_R x*y = sum_R2 y *
    (sum_R1 x)`` when y is independent of R1 (associativity + distributivity,
    the paper's "small set of core algebraic transformations")."""

    chain: ReductionChain
    factor_mul: int  # index into chain.muls of the multiplicand to factor out

    @property
    def name(self) -> str:
        return f"factor_reduction(@{self.chain.start},mul={self.factor_mul})"

    def apply(self, prog: Program) -> Program:
        ch = self.chain
        stmts = prog.statements
        s_init = stmts[ch.start]
        s_muls = [stmts[m] for m in ch.muls]
        s_end = stmts[ch.end]
        bf = s_muls[self.factor_mul]
        rest = [s for idx, s in enumerate(s_muls) if idx != self.factor_mul]

        out_axes = set(_axes_used(prog, s_end.lhs))
        group1_axes: set[str] = set(_axes_used(prog, s_init.rhs))
        for s in rest:
            group1_axes |= set(_axes_used(prog, s.rhs))
        bf_axes = set(_axes_used(prog, bf.rhs))
        chain_axes = set(_axes_used(prog, s_end.rhs))  # all axes of the temp
        reduction = chain_axes - out_axes
        r1 = (reduction - bf_axes) & group1_axes
        if not r1:
            raise IRError("factoring does not reduce anything (R1 empty)")

        order = list(prog.axis_names)
        u_axes = sorted((group1_axes - r1) | (bf_axes & chain_axes & group1_axes),
                        key=order.index)
        # U must carry everything group 2 still needs from group 1:
        u_axes = sorted(group1_axes - r1, key=order.index)
        ta_axes = sorted(group1_axes, key=order.index)
        tb_axes = sorted((set(u_axes) | bf_axes | out_axes) & (chain_axes | out_axes),
                         key=order.index)

        sz = {a.name: a.size for a in prog.axes}
        ta = Buffer(f"{ch.temp}_a", tuple(sz[a] for a in ta_axes), temp=True)
        U = Buffer(f"{ch.temp}_u", tuple(sz[a] for a in u_axes), temp=True)
        tb = Buffer(f"{ch.temp}_b", tuple(sz[a] for a in tb_axes), temp=True)
        names = prog.axis_names

        new_stmts = list(stmts[:ch.start])
        # group 1: ta := A; ta *= B_i (i != f); U += ta
        new_stmts.append(Statement(":=", _identity_access(ta.name, ta_axes, names),
                                   s_init.rhs))
        for s in rest:
            new_stmts.append(Statement("*=", _identity_access(ta.name, ta_axes, names),
                                       s.rhs))
        new_stmts.append(Statement("+=", _identity_access(U.name, u_axes, names),
                                   _identity_access(ta.name, ta_axes, names)))
        # group 2: tb := U; tb *= B_f; C += tb
        new_stmts.append(Statement(":=", _identity_access(tb.name, tb_axes, names),
                                   _identity_access(U.name, u_axes, names)))
        new_stmts.append(Statement("*=", _identity_access(tb.name, tb_axes, names),
                                   bf.rhs))
        new_stmts.append(Statement("+=", s_end.lhs,
                                   _identity_access(tb.name, tb_axes, names)))
        new_stmts.extend(stmts[ch.end + 1:])

        buffers = tuple(b for b in prog.buffers if b.name != ch.temp) + (ta, U, tb)
        return Program(prog.name + "+fct", prog.axes, buffers, tuple(new_stmts),
                       prog.outputs)


# --------------------------------------------------------------------------- #
# Axis splitting (tiling to fixed-extent needles)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True, repr=False)
class SplitAxis(Transform):
    """Split axis ``a`` (extent N = outer*factor) into ``a_o``, ``a_i``:
    every access coefficient ``c*a`` becomes ``c*factor*a_o + c*a_i``."""

    axis: str
    factor: int

    @property
    def name(self) -> str:
        return f"split_axis({self.axis},{self.factor})"

    def apply(self, prog: Program) -> Program:
        ai = prog.axis_index(self.axis)
        old = prog.axes[ai]
        if old.size % self.factor:
            raise IRError(f"extent {old.size} not divisible by {self.factor}")
        outer = Axis(f"{self.axis}_o", old.size // self.factor)
        inner = Axis(f"{self.axis}_i", self.factor)
        axes = prog.axes[:ai] + (outer, inner) + prog.axes[ai + 1:]

        def rewrite(acc: Access) -> Access:
            mat = []
            for row in acc.matrix:
                c = row[ai]
                mat.append(row[:ai] + (c * self.factor, c) + row[ai + 1:])
            return Access(acc.buffer, tuple(mat), acc.offset)

        stmts = tuple(Statement(s.op, rewrite(s.lhs), rewrite(s.rhs), s.fn)
                      for s in prog.statements)
        return Program(prog.name + f"+split_{self.axis}", axes, prog.buffers,
                       stmts, prog.outputs)


# --------------------------------------------------------------------------- #
# Unit-dimension insertion (rank adaptation)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True, repr=False)
class InsertUnitDim(Transform):
    """Append a size-1 dimension to ``buffer`` (and a fresh size-1 axis), so
    lower-rank haystack buffers can satisfy higher-rank needle operands."""

    buffer: str

    @property
    def name(self) -> str:
        return f"insert_unit_dim({self.buffer})"

    def apply(self, prog: Program) -> Program:
        uax = Axis(f"_u_{self.buffer}", 1)
        axes = prog.axes + (uax,)
        buffers = []
        for b in prog.buffers:
            if b.name == self.buffer:
                buffers.append(Buffer(b.name, b.shape + (1,), b.dtype, b.temp))
            else:
                buffers.append(b)

        ncols = len(prog.axes)

        def rewrite(acc: Access) -> Access:
            mat = tuple(row + (0,) for row in acc.matrix)
            if acc.buffer == self.buffer:
                mat = mat + ((0,) * ncols + (1,),)
                return Access(acc.buffer, mat, acc.offset + (0,))
            return Access(acc.buffer, mat, acc.offset)

        stmts = tuple(Statement(s.op, rewrite(s.lhs), rewrite(s.rhs), s.fn)
                      for s in prog.statements)
        return Program(prog.name + f"+unit_{self.buffer}", tuple(axes),
                       tuple(buffers), stmts, prog.outputs)

    def adapt_inputs(self, inputs: dict) -> dict:
        out = dict(inputs)
        if self.buffer in out:
            out[self.buffer] = np.asarray(out[self.buffer])[..., None]
        return out

    def adapt_outputs(self, outputs: dict) -> dict:
        out = dict(outputs)
        if self.buffer in out:
            out[self.buffer] = np.asarray(out[self.buffer])[..., 0]
        return out


# --------------------------------------------------------------------------- #
# Axis fusion (call-count optimization: fold batch/spatial loops into GEMM M)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True, repr=False)
class DropUnitAxes(Transform):
    """Remove extent-1 axes (their index contribution is always 0).  A
    cleanup pass that unblocks FuseAxes on e.g. 1x1 convolutions whose
    kernel axes survive with size 1."""

    @property
    def name(self) -> str:
        return "drop_unit_axes"

    def apply(self, prog: Program) -> Program:
        keep = [i for i, a in enumerate(prog.axes) if a.size != 1]
        if len(keep) == len(prog.axes):
            raise IRError("no unit axes")

        def rewrite(acc: Access) -> Access:
            return Access(acc.buffer,
                          tuple(tuple(row[c] for c in keep)
                                for row in acc.matrix), acc.offset)

        stmts = tuple(Statement(s.op, rewrite(s.lhs), rewrite(s.rhs), s.fn)
                      for s in prog.statements)
        return Program(prog.name + "+duax",
                       tuple(prog.axes[i] for i in keep), prog.buffers,
                       stmts, prog.outputs)


@dataclass(frozen=True, repr=False)
class FuseAxes(Transform):
    """Fuse adjacent axes ``a1, a2`` into one (row-major: a1*n2 + a2).

    Legal when every access that touches either axis indexes them through two
    consecutive dedicated coeff-1 dims whose inner buffer dim is *exactly*
    ``n2`` — then merging the dims preserves the linear index.  This is what
    turns a 1x1 convolution's (b, y, x) loop nest into a single GEMM M
    dimension (the ISAM-TVM reordering of paper Section 7)."""

    a1: str
    a2: str

    @property
    def name(self) -> str:
        return f"fuse_axes({self.a1},{self.a2})"

    def apply(self, prog: Program) -> Program:
        i1, i2 = prog.axis_index(self.a1), prog.axis_index(self.a2)
        n1, n2 = prog.axis(self.a1).size, prog.axis(self.a2).size
        merges: dict[str, tuple[int, int]] = {}
        for s in prog.statements:
            for acc in (s.lhs, s.rhs):
                r1 = [d for d, row in enumerate(acc.matrix) if row[i1]]
                r2 = [d for d, row in enumerate(acc.matrix) if row[i2]]
                if not r1 and not r2:
                    continue
                if len(r1) != 1 or len(r2) != 1 or r2[0] != r1[0] + 1:
                    raise IRError(f"{acc.buffer}: axes not in consecutive "
                                  f"dedicated dims")
                d1, d2 = r1[0], r2[0]
                row1, row2 = acc.matrix[d1], acc.matrix[d2]
                if (row1[i1] != 1 or row2[i2] != 1
                        or any(c for j, c in enumerate(row1) if j != i1)
                        or any(c for j, c in enumerate(row2) if j != i2)
                        or acc.offset[d1] or acc.offset[d2]):
                    raise IRError(f"{acc.buffer}: non-identity axis usage")
                if prog.buffer(acc.buffer).shape[d2] != n2:
                    raise IRError(f"{acc.buffer}: inner dim != axis extent")
                prev = merges.get(acc.buffer)
                if prev is not None and prev != (d1, d2):
                    raise IRError(f"{acc.buffer}: inconsistent merge dims")
                merges[acc.buffer] = (d1, d2)
        if not merges:
            raise IRError("fusion touches nothing")
        object.__setattr__(self, "_merges", merges)

        fused_name = f"{self.a1}{self.a2}"
        axes = []
        for idx, a in enumerate(prog.axes):
            if idx == i1:
                axes.append(Axis(fused_name, n1 * n2))
            elif idx == i2:
                continue
            else:
                axes.append(a)
        keep_cols = [idx for idx in range(len(prog.axes)) if idx != i2]
        fused_col = keep_cols.index(i1)

        buffers = []
        for b in prog.buffers:
            if b.name in merges:
                d1, d2 = merges[b.name]
                shape = (b.shape[:d1] + (b.shape[d1] * b.shape[d2],)
                         + b.shape[d2 + 1:])
                buffers.append(Buffer(b.name, shape, b.dtype, b.temp))
            else:
                buffers.append(b)

        def rewrite(acc: Access) -> Access:
            rows = [tuple(row[c] for c in keep_cols) for row in acc.matrix]
            offs = list(acc.offset)
            if acc.buffer in merges:
                d1, d2 = merges[acc.buffer]
                merged = list(rows[d1])
                merged[fused_col] = 1
                rows = rows[:d1] + [tuple(merged)] + rows[d2 + 1:]
                offs = offs[:d1] + [0] + offs[d2 + 1:]
            return Access(acc.buffer, tuple(rows), tuple(offs))

        stmts = tuple(Statement(s.op, rewrite(s.lhs), rewrite(s.rhs), s.fn)
                      for s in prog.statements)
        return Program(prog.name + f"+fuse_{self.a1}{self.a2}", tuple(axes),
                       tuple(buffers), stmts, prog.outputs)

    def _reshape(self, arrs: dict, inverse: bool) -> dict:
        merges = getattr(self, "_merges", {})
        out = dict(arrs)
        for bname, (d1, d2) in merges.items():
            if bname not in out:
                continue
            a = np.asarray(out[bname])
            if inverse:
                # only outputs come back; shapes tracked by caller
                continue
            shape = a.shape[:d1] + (a.shape[d1] * a.shape[d2],) + a.shape[d2 + 1:]
            out[bname] = a.reshape(shape)
        return out

    def adapt_inputs(self, inputs: dict) -> dict:
        return self._reshape(inputs, inverse=False)

    def adapt_outputs(self, outputs: dict) -> dict:
        # callers compare against original shapes; un-merge is shape-driven
        merges = getattr(self, "_merges", {})
        out = dict(outputs)
        for bname, (d1, d2) in merges.items():
            if bname in out:
                a = np.asarray(out[bname])
                out[bname] = a  # shape restored by caller reshape if needed
        return out


def fuse_axes_for_calls(prog: Program, isa: list[Program],
                        max_fusions: int = 4):
    """Greedy performance pass: keep fusing axis pairs while the selected
    instruction cover needs fewer total calls (the Approach-style heuristic
    behind the ISAM-TVM loop-nest reordering)."""
    from .isel import select_instructions
    steps: list[Transform] = []
    try:
        t0 = DropUnitAxes()
        prog = t0.apply(prog)
        steps.append(t0)
    except IRError:
        pass
    sel = select_instructions(prog, isa, allow_transforms=False)
    for _ in range(max_fusions):
        best = None
        names = prog.axis_names
        for x1 in names:
            for x2 in names:
                if x1 == x2:
                    continue
                t = FuseAxes(x1, x2)
                try:
                    p2 = t.apply(prog)
                except IRError:
                    continue
                sel2 = select_instructions(p2, isa, allow_transforms=False)
                if not sel2.complete:
                    continue
                if best is None or sel2.total_calls() < best[1].total_calls():
                    best = (p2, sel2, t)
        if best is None or best[1].total_calls() >= sel.total_calls():
            break
        prog, sel, t = best
        steps.append(t)
    return prog, sel, steps


# --------------------------------------------------------------------------- #
# Feedback-guided proposal + search (the non-deterministic mapper)
# --------------------------------------------------------------------------- #


def propose_transforms(prog: Program, failures: Iterable[MapFailure],
                       needle: Program) -> list[Transform]:
    """Paper Section 2.3: 'the deterministic mapper can report where and why
    it failed to map ... the non-deterministic mapper can then use this
    information, along with prior knowledge of what the factorization pass
    does, to determine that performing the factorization pass would make the
    needed change.'"""
    props: list[Transform] = []
    kinds = {f.kind for f in failures}

    # Extra multiplication blocking a reduction window -> factor it out.
    if kinds & {"not_extractable", "op_mismatch"}:
        for ch in find_reduction_chains(prog, min_muls=2):
            for f in range(len(ch.muls)):
                props.append(FactorReduction(ch, f))

    # Fixed-extent needle axes -> tile haystack axes by splitting.
    for f in failures:
        if f.kind == "extent_mismatch":
            # detail: "... needs extent E, haystack <axis> has N"
            for na in needle.axes:
                if not na.size:
                    continue
                for ha in prog.axes:
                    if ha.size > na.size and ha.size % na.size == 0:
                        t = SplitAxis(ha.name, na.size)
                        if t.name not in {p.name for p in props}:
                            props.append(t)

    # Needle operand rank exceeds haystack buffer rank -> add unit dims.
    if "dim_exhausted" in kinds:
        for b in prog.buffers:
            if not b.temp:
                props.append(InsertUnitDim(b.name))

    return props


@dataclass
class SearchResult:
    program: Program
    steps: tuple[Transform, ...]
    mapping_result: MapResult

    def adapt_inputs(self, inputs: dict) -> dict:
        for t in self.steps:
            inputs = t.adapt_inputs(inputs)
        return inputs

    def adapt_outputs(self, outputs: dict) -> dict:
        for t in reversed(self.steps):
            outputs = t.adapt_outputs(outputs)
        return outputs


def search_mappings(haystack: Program, needle: Program, max_depth: int = 3,
                    beam: int = 24, max_results: int = 8) -> list[SearchResult]:
    """Breadth-first, feedback-guided search over transformation sequences
    (Figure 1's loop between the non-deterministic sampler and the
    deterministic mapper).  Returns programs on which the needle maps."""
    results: list[SearchResult] = []
    frontier: list[tuple[Program, tuple[Transform, ...]]] = [(haystack, ())]
    seen = {haystack.signature()}

    for _ in range(max_depth + 1):
        nxt: list[tuple[Program, tuple[Transform, ...]]] = []
        for prog, steps in frontier:
            res = map_program(prog, needle)
            if res.ok:
                results.append(SearchResult(prog, steps, res))
                if len(results) >= max_results:
                    return results
                continue  # mapped — no need to transform further
            for t in propose_transforms(prog, res.failures, needle):
                try:
                    p2 = t.apply(prog)
                except IRError:
                    continue
                sig = p2.signature()
                if sig in seen:
                    continue
                seen.add(sig)
                nxt.append((p2, steps + (t,)))
                if len(nxt) >= beam:
                    break
        frontier = nxt
        if not frontier:
            break
    return results


# --------------------------------------------------------------------------- #
# Epilogue fusion (the graph tier's producer+consumer composition)
# --------------------------------------------------------------------------- #


def _is_identity_access(prog: Program, acc: Access) -> bool:
    """True iff dim d of the access reads axis d directly (the elementwise
    same-shape pattern): identity coefficient matrix over a prefix of the
    program axes, zero offsets."""
    if any(o != 0 for o in acc.offset):
        return False
    for d, row in enumerate(acc.matrix):
        for a, coeff in enumerate(row):
            if coeff != (1 if a == d else 0):
                return False
    return True


def _output_axes(prog: Program, out: str) -> list[str]:
    """The program axes indexing each dim of output buffer ``out`` — every
    access of ``out`` must agree and use exactly one axis per dim."""
    axes: list[str] | None = None
    for s in prog.statements:
        for acc in (s.lhs, s.rhs):
            if acc.buffer != out:
                continue
            cur = []
            for row, off in zip(acc.matrix, acc.offset):
                hits = [a for a, c in enumerate(row) if c]
                if off != 0 or len(hits) != 1 or row[hits[0]] != 1:
                    raise IRError(
                        f"{prog.name}: output {out} access is not "
                        f"axis-aligned; cannot fuse an epilogue onto it")
                cur.append(prog.axis_names[hits[0]])
            if axes is None:
                axes = cur
            elif axes != cur:
                raise IRError(
                    f"{prog.name}: output {out} accessed with inconsistent "
                    f"axis order")
    if axes is None:
        raise IRError(f"{prog.name}: output {out} is never accessed")
    return axes


def fuse_epilogue(producer: Program, consumer: Program, wire: str,
                  name: str | None = None,
                  return_map: bool = False):
    """Fold an elementwise ``consumer`` program into ``producer``.

    ``wire`` names the consumer buffer fed by the producer's (single)
    output.  The composed program applies the consumer's statements directly
    to the producer's output buffer — the graph tier's generalization of the
    conv→matmul extraction idiom: compose programs, let instruction
    selection cover the result with fused/VPU needles.

    Supported consumer shapes (everything ``repro.graph.trace`` emits):

      * unary chains starting from ``wire`` — ``O := fn(W); O := fn(O); ...``
      * copy-accumulate — ``O := W; O op= B; ...``
      * accumulate-into — ``O := B; O op= W`` with commutative ``op``
        (rewritten as ``C op= B``, valid because C already holds W's value)

    Raises ``IRError`` when the consumer does not match (the fusion pass
    treats that as "not fusable", not as an error).
    """
    if len(producer.outputs) != 1 or len(consumer.outputs) != 1:
        raise IRError("epilogue fusion needs single-output programs")
    c_name = producer.outputs[0]
    out = consumer.outputs[0]
    if wire == out or wire not in {b.name for b in consumer.buffers}:
        raise IRError(f"bad wire buffer {wire!r}")
    c_buf = producer.buffer(c_name)
    c_axes = _output_axes(producer, c_name)
    ax_index = {a: i for i, a in enumerate(producer.axis_names)}

    # the consumer must be pure elementwise over the producer-output shape
    if tuple(a.size for a in consumer.axes) != tuple(c_buf.shape):
        raise IRError("consumer iteration space != producer output shape")
    for s in consumer.statements:
        for acc in (s.lhs, s.rhs):
            if not _is_identity_access(consumer, acc):
                raise IRError("consumer access is not identity/elementwise")
    for b in consumer.buffers:
        if tuple(b.shape) != tuple(c_buf.shape):
            raise IRError("consumer buffer shape != producer output shape")
    if sum(s.rhs.buffer == wire for s in consumer.statements) != 1:
        raise IRError("wire buffer must be read exactly once")

    # rename consumer buffers into the producer namespace
    taken = {b.name for b in producer.buffers}
    rename = {wire: c_name, out: c_name}
    extra: list[Buffer] = []
    for b in consumer.buffers:
        if b.name in rename:
            continue
        nn, i = b.name, 0
        while nn in taken:
            i += 1
            nn = f"{b.name}_e{i}"
        taken.add(nn)
        rename[b.name] = nn
        extra.append(Buffer(nn, tuple(b.shape), b.dtype, b.temp))

    mat = tuple(tuple(1 if a == ax_index[c_axes[d]] else 0
                      for a in range(len(producer.axes)))
                for d in range(len(c_axes)))

    def remap(acc: Access) -> Access:
        return Access(rename[acc.buffer], mat)

    stmts = list(consumer.statements)
    epilogue: list[Statement] = []
    if stmts and stmts[0].rhs.buffer != wire:
        # accumulate-into: O := B; O op= W  ->  C op= B
        if (len(stmts) != 2 or stmts[0].op != ":="
                or stmts[1].rhs.buffer != wire
                or stmts[1].op not in ("+=", "*=", "max=")):
            raise IRError("unsupported epilogue shape")
        epilogue.append(Statement(stmts[1].op, remap(stmts[1].lhs),
                                  remap(stmts[0].rhs)))
    else:
        for i, s in enumerate(stmts):
            if i == 0 and s.op == ":=":
                continue                      # O := W — C already holds it
            epilogue.append(Statement(s.op, remap(s.lhs), remap(s.rhs),
                                      s.fn))

    fused = Program(name or f"{producer.name}+{consumer.name}",
                    producer.axes, producer.buffers + tuple(extra),
                    producer.statements + tuple(epilogue), producer.outputs)
    return (fused, dict(rename)) if return_map else fused
