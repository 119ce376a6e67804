"""Layer 1 — ISAMIR program legality (``prg.*`` rules).

Checks a ``core.ir.Program`` statically: access ranks and matrix widths,
affine in-bounds under the axis extents, temps written before read, declared
outputs actually written, dtypes known to ``core/dtypes.py``.

``Program.__post_init__`` raises ``IRError`` on some of these at construction
time; the verifier re-checks them because mutated/deserialized programs
bypass the constructor (``object.__setattr__``, pickles, cache payloads) —
and because a Diagnostic with a rule id is more useful than a bare exception.
"""
from __future__ import annotations

from ..core.dtypes import DTYPE_BYTES
from ..core.ir import Access, Program
from .diagnostics import Diagnostic, diag


def _access_extremes(acc: Access, extents: list[int]) -> list[tuple[int, int]]:
    """Per-dim (min, max) index of an affine access over the axis domain."""
    out = []
    for row, off in zip(acc.matrix, acc.offset):
        lo = hi = off
        for coeff, ext in zip(row, extents):
            if coeff == 0 or ext <= 0:      # ext 0 = symbolic axis: skip
                continue
            span = coeff * (ext - 1)
            if span > 0:
                hi += span
            else:
                lo += span
        out.append((lo, hi))
    return out


def verify_program(prog: Program) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    bufs = {b.name: b for b in prog.buffers}
    extents = [a.size for a in prog.axes]
    ncols = len(prog.axes)

    for b in prog.buffers:
        if b.dtype not in DTYPE_BYTES:
            diags.append(diag(
                "prg.dtype", f"buffer {b.name!r} has unknown dtype "
                f"{b.dtype!r} (not in core/dtypes.py)", subject=b.name))

    written: set[str] = set()
    for i, s in enumerate(prog.statements):
        for side, acc in (("lhs", s.lhs), ("rhs", s.rhs)):
            b = bufs.get(acc.buffer)
            if b is None:
                diags.append(diag(
                    "prg.unknown-buffer",
                    f"stmt {i} {side} accesses unknown buffer "
                    f"{acc.buffer!r}", subject=acc.buffer, uid=i))
                continue
            if acc.rank != b.rank:
                diags.append(diag(
                    "prg.rank",
                    f"stmt {i} {side}: access rank {acc.rank} != buffer "
                    f"{b.name!r} rank {b.rank}", subject=b.name, uid=i))
                continue
            bad_width = [len(row) for row in acc.matrix if len(row) != ncols]
            if bad_width:
                diags.append(diag(
                    "prg.axis",
                    f"stmt {i} {side}: access matrix row width "
                    f"{bad_width[0]} != {ncols} declared axes",
                    subject=b.name, uid=i))
                continue
            for d, (lo, hi) in enumerate(_access_extremes(acc, extents)):
                if lo < 0 or hi >= b.shape[d]:
                    diags.append(diag(
                        "prg.bounds",
                        f"stmt {i} {side}: dim {d} of {b.name!r} spans "
                        f"[{lo}, {hi}] outside [0, {b.shape[d] - 1}]",
                        subject=b.name, uid=i))
        # temps must be written before read (non-temps are inputs, implicitly
        # zero/user-initialized; temps are pure scratch).  An accumulating
        # op's *own* lhs is exempt: ``T += ...`` as the first write is the
        # idiomatic zero-init (``interpret`` zero-fills missing buffers).
        try:
            stmt_reads = prog.reads(s)
        except KeyError:
            stmt_reads = ()
        for r in stmt_reads:
            if r == s.lhs.buffer:
                continue
            b = bufs.get(r)
            if b is not None and b.temp and r not in written:
                diags.append(diag(
                    "prg.temp-read",
                    f"stmt {i} reads temp {r!r} before any write",
                    subject=r, uid=i))
        written.add(s.lhs.buffer)

    for name in prog.outputs:
        if name not in bufs:
            diags.append(diag(
                "prg.unknown-buffer",
                f"declared output {name!r} is not a buffer", subject=name))
        elif name not in written:
            diags.append(diag(
                "prg.output-unwritten",
                f"output {name!r} is never written", subject=name))
    return diags
