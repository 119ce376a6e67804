"""Deterministic instruction mapping (paper Section 2.2).

Given a *haystack* program and a *needle* program (a hardware instruction
expressed in ISAMIR), find every way the needle can be identified inside the
haystack.  A mapping consists of:

  * a **statement map** — which haystack statements realise each needle
    statement (an increasing, extractable subsequence with matching op kinds),
  * a **buffer map** — injective needle buffer → haystack buffer,
  * a **dimension map** — per mapped buffer, injective needle dim → haystack dim,
  * an **axis map** — injective needle loop axis → haystack loop axis.

Matching is permuted-submatrix equality of the affine access matrices: for
every mapped access pair, every mapped (dim, axis) entry must agree.  Haystack
axes left unmapped become *outer* axes — the instruction is invoked once per
point of their domain (with operand views shifted accordingly); haystack dims
left unmapped must not vary with any mapped axis.

The search is a pruned recursive backtracking in the spirit of VF2
(Cordella et al., 2004): whole branches are abandoned at the first
inconsistent binding.  On failure the mapper reports structured *feedback*
(paper Section 2.3) that the non-deterministic transformation search uses to
choose which IR transformation to try next.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

from .ir import Access, Program

# --------------------------------------------------------------------------- #
# Results
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class InstrMapping:
    """One way of realising ``needle`` inside ``haystack``."""

    needle_name: str
    stmt_map: tuple[int, ...]                 # needle stmt i -> haystack stmt idx
    buffer_map: tuple[tuple[str, str], ...]   # (needle buf, haystack buf)
    dim_map: tuple[tuple[str, tuple[int, ...]], ...]  # needle buf -> hay dim per needle dim
    axis_map: tuple[tuple[str, str], ...]     # (needle axis, haystack axis)
    outer_axes: tuple[str, ...]               # haystack axes not mapped

    def buffer_of(self, needle_buf: str) -> str:
        return dict(self.buffer_map)[needle_buf]

    def hay_axis(self, needle_axis: str) -> str:
        return dict(self.axis_map)[needle_axis]

    def mapped_axes(self) -> tuple[str, ...]:
        return tuple(h for _, h in self.axis_map)

    def calls(self, haystack: Program) -> int:
        """Number of instruction invocations = |outer axis domain|."""
        n = 1
        for a in self.outer_axes:
            n *= haystack.axis(a).size
        return n


@dataclass(frozen=True)
class MapFailure:
    """Structured feedback for the transformation search (Section 2.3)."""

    kind: str          # op_mismatch | coeff_mismatch | buffer_conflict |
                       # dim_exhausted | temp_escapes | extent_mismatch |
                       # not_extractable | axis_unbound
    needle_stmt: int = -1
    haystack_stmt: int = -1
    detail: str = ""

    def __str__(self) -> str:  # pragma: no cover
        return (f"{self.kind}(needle stmt {self.needle_stmt}, "
                f"haystack stmt {self.haystack_stmt}): {self.detail}")


@dataclass
class MapResult:
    mappings: list[InstrMapping]
    failures: list[MapFailure]

    @property
    def ok(self) -> bool:
        return bool(self.mappings)

    def best(self, haystack: Program) -> InstrMapping:
        """Mapping covering the largest mapped iteration volume (fewest calls)."""
        return min(self.mappings, key=lambda m: m.calls(haystack))


# --------------------------------------------------------------------------- #
# Internal search state
# --------------------------------------------------------------------------- #


class _State:
    __slots__ = ("bmap", "brev", "dmap", "amap", "arev")

    def __init__(self):
        self.bmap: dict[str, str] = {}
        self.brev: dict[str, str] = {}
        self.dmap: dict[str, dict[int, int]] = {}
        self.amap: dict[str, str] = {}
        self.arev: dict[str, str] = {}

    def clone(self) -> "_State":
        s = _State.__new__(_State)
        s.bmap = dict(self.bmap)
        s.brev = dict(self.brev)
        s.dmap = {k: dict(v) for k, v in self.dmap.items()}
        s.amap = dict(self.amap)
        s.arev = dict(self.arev)
        return s


# --------------------------------------------------------------------------- #
# Mapper
# --------------------------------------------------------------------------- #


class Mapper:
    def __init__(self, haystack: Program, needle: Program,
                 max_results: int = 32, max_windows: int = 512):
        self.h = haystack
        self.n = needle
        self.max_results = max_results
        self.max_windows = max_windows
        self.failures: list[MapFailure] = []
        self.results: list[InstrMapping] = []

    # ---- public ----------------------------------------------------------
    def run(self) -> MapResult:
        any_window = False
        for window in self._windows():
            any_window = True
            if not self._extractable(window):
                self.failures.append(MapFailure(
                    "not_extractable", haystack_stmt=window[0],
                    detail=f"window {window} cannot be reordered to be atomic"))
                continue
            self._match_window(window)
            if len(self.results) >= self.max_results:
                break
        if not any_window:
            self._report_best_prefix()
        return MapResult(self.results, self.failures)

    # ---- statement windows -------------------------------------------------
    def _windows(self):
        """Yield increasing haystack-index tuples whose op kinds match the
        needle's statement kinds, bounded by ``max_windows``."""
        nk = [s.kind for s in self.n.statements]
        hk = [s.kind for s in self.h.statements]
        count = 0

        def rec(ni: int, start: int, acc: tuple[int, ...]):
            nonlocal count
            if count >= self.max_windows:
                return
            if ni == len(nk):
                count += 1
                yield acc
                return
            for hi in range(start, len(hk) - (len(nk) - ni) + 1):
                if hk[hi] == nk[ni]:
                    yield from rec(ni + 1, hi + 1, acc + (hi,))

        yield from rec(0, 0, ())

    def _report_best_prefix(self):
        """No op-kind window exists: report where the best prefix diverges —
        this is the feedback that drives transformation selection."""
        nk = [s.kind for s in self.n.statements]
        hk = [s.kind for s in self.h.statements]
        best_len = -1
        best_at = (0, 0)
        for start in range(len(hk)):
            ni, hi = 0, start
            while ni < len(nk) and hi < len(hk):
                if hk[hi] == nk[ni]:
                    ni += 1
                hi += 1
            if ni > best_len:
                best_len = ni
                # position where we ran out
                best_at = (ni, min(start + ni, len(hk) - 1))
        ni, hi = best_at
        found = hk[hi] if hi < len(hk) else "<end>"
        expected = nk[ni] if ni < len(nk) else "<end>"
        self.failures.append(MapFailure(
            "op_mismatch", needle_stmt=min(ni, len(nk) - 1), haystack_stmt=hi,
            detail=f"expected {expected!r} found {found!r}"))

    def _extractable(self, window: tuple[int, ...]) -> bool:
        """Legality of hoisting all window statements to the last position
        (so the window can be replaced by one atomic instruction call)."""
        wset = set(window)
        lo, hi = window[0], window[-1]
        for u in range(lo + 1, hi):
            if u in wset:
                continue
            us = self.h.statements[u]
            u_reads = set(self.h.reads(us))
            u_writes = self.h.writes(us)
            for m in window:
                if m >= u:
                    break
                ms = self.h.statements[m]
                m_writes = self.h.writes(ms)
                m_reads = set(self.h.reads(ms))
                if m_writes in u_reads:   # u needs m's (now delayed) write
                    return False
                if u_writes in m_reads:   # m would read u's later value
                    return False
                if u_writes == m_writes:  # WAW inversion
                    return False
        return True

    # ---- access unification ------------------------------------------------
    def _match_window(self, window: tuple[int, ...]):
        pairs: list[tuple[Access, Access, int, int]] = []
        for ni, hi in enumerate(window):
            ns, hs = self.n.statements[ni], self.h.statements[hi]
            pairs.append((ns.lhs, hs.lhs, ni, hi))
            pairs.append((ns.rhs, hs.rhs, ni, hi))
        self._unify(pairs, 0, _State(), window)

    def _unify(self, pairs, idx: int, st: _State, window: tuple[int, ...]):
        if len(self.results) >= self.max_results:
            return
        if idx == len(pairs):
            self._finalize(st, window)
            return
        na, ha, ni, hi = pairs[idx]

        # --- buffer binding
        if na.buffer in st.bmap:
            if st.bmap[na.buffer] != ha.buffer:
                self.failures.append(MapFailure(
                    "buffer_conflict", ni, hi,
                    f"{na.buffer} already bound to {st.bmap[na.buffer]}, "
                    f"now needs {ha.buffer}"))
                return
        elif ha.buffer in st.brev:
            self.failures.append(MapFailure(
                "buffer_conflict", ni, hi,
                f"haystack buffer {ha.buffer} already bound"))
            return

        nb, hb = self.n.buffer(na.buffer), self.h.buffer(ha.buffer)
        if nb.rank > hb.rank:
            self.failures.append(MapFailure(
                "dim_exhausted", ni, hi,
                f"needle buffer {nb.name} rank {nb.rank} > haystack "
                f"{hb.name} rank {hb.rank}"))
            return

        base = st.clone()
        base.bmap[na.buffer] = ha.buffer
        base.brev[ha.buffer] = na.buffer
        base.dmap.setdefault(na.buffer, {})

        # --- dim assignments (branch over unbound needle dims)
        for st2 in self._assign_dims(base, na, ha, ni, hi):
            # --- axis assignments implied by entries of this access pair
            for st3 in self._assign_axes(st2, na, ha, ni, hi):
                self._unify(pairs, idx + 1, st3, window)

    def _assign_dims(self, st: _State, na: Access, ha: Access, ni: int, hi: int):
        dmap = st.dmap[na.buffer]
        unbound_n = [d for d in range(na.rank) if d not in dmap]
        if not unbound_n:
            yield st
            return
        bound_h = set(dmap.values())
        unbound_h = [d for d in range(ha.rank) if d not in bound_h]
        if len(unbound_n) > len(unbound_h):
            self.failures.append(MapFailure(
                "dim_exhausted", ni, hi,
                f"{len(unbound_n)} needle dims for {len(unbound_h)} haystack dims"))
            return
        for perm in itertools.permutations(unbound_h, len(unbound_n)):
            st2 = st.clone()
            for d, D in zip(unbound_n, perm):
                st2.dmap[na.buffer][d] = D
            yield st2

    def _assign_axes(self, st: _State, na: Access, ha: Access, ni: int, hi: int):
        """Bind axes so that all (dim, axis) entries of this access pair agree.
        Branch over candidates for unbound needle axes with nonzero coeffs."""
        nmat, hmat = na.matrix, ha.matrix
        n_axes = self.n.axis_names
        h_axes = self.h.axis_names
        dmap = st.dmap[na.buffer]

        # Collect (needle axis idx, required coeff, haystack row) constraints.
        todo: list[tuple[int, int, tuple[int, ...]]] = []
        for d in range(na.rank):
            D = dmap[d]
            nrow, hrow = nmat[d], hmat[D]
            for a, coeff in enumerate(nrow):
                an = n_axes[a]
                if an in st.amap:
                    A = self.h.axis_index(st.amap[an])
                    if hrow[A] != coeff:
                        self.failures.append(MapFailure(
                            "coeff_mismatch", ni, hi,
                            f"axis {an}->{st.amap[an]}: needle coeff {coeff} "
                            f"vs haystack {hrow[A]} in {ha.buffer}[{D}]"))
                        return
                elif coeff != 0:
                    todo.append((a, coeff, hrow))
            # Bound haystack axes must not appear where the needle row is zero.
            for A, hcoeff in enumerate(hrow):
                hn = h_axes[A]
                if hn in st.arev and hcoeff != 0:
                    an2 = st.arev[hn]
                    a2 = self.n.axis_names.index(an2)
                    if nrow[a2] != hcoeff:
                        self.failures.append(MapFailure(
                            "coeff_mismatch", ni, hi,
                            f"haystack axis {hn} (bound to {an2}) has coeff "
                            f"{hcoeff} where needle has {nrow[a2]}"))
                        return

        def rec(t: int, cur: _State):
            if t == len(todo):
                yield cur
                return
            a, coeff, hrow = todo[t]
            an = n_axes[a]
            if an in cur.amap:       # bound by an earlier constraint in `todo`
                A = self.h.axis_index(cur.amap[an])
                if hrow[A] == coeff:
                    yield from rec(t + 1, cur)
                else:
                    self.failures.append(MapFailure(
                        "coeff_mismatch", ni, hi,
                        f"axis {an} bound inconsistently"))
                return
            cands = [A for A, c in enumerate(hrow)
                     if c == coeff and h_axes[A] not in cur.arev]
            if not cands:
                self.failures.append(MapFailure(
                    "coeff_mismatch", ni, hi,
                    f"no haystack axis with coeff {coeff} for needle axis {an} "
                    f"in {ha.buffer}"))
                return
            for A in cands:
                nx = cur.clone()
                nx.amap[an] = h_axes[A]
                nx.arev[h_axes[A]] = an
                yield from rec(t + 1, nx)

        yield from rec(0, st)

    # ---- final validation ---------------------------------------------------
    def _finalize(self, st: _State, window: tuple[int, ...]):
        # 1. all needle axes bound
        for a in self.n.axes:
            if a.name not in st.amap:
                self.failures.append(MapFailure(
                    "axis_unbound", detail=f"needle axis {a.name} never bound"))
                return

        # 2. extent compatibility (fixed-size needles)
        for a in self.n.axes:
            if a.size:
                hsz = self.h.axis(st.amap[a.name]).size
                if hsz != a.size:
                    self.failures.append(MapFailure(
                        "extent_mismatch",
                        detail=f"needle axis {a.name} needs extent {a.size}, "
                               f"haystack {st.amap[a.name]} has {hsz}"))
                    return

        mapped_h_axes = set(st.arev)

        # 3. global coefficient re-check + unmapped-dim independence
        for ni, hi in enumerate(window):
            for na, ha in ((self.n.statements[ni].lhs, self.h.statements[hi].lhs),
                           (self.n.statements[ni].rhs, self.h.statements[hi].rhs)):
                dmap = st.dmap[na.buffer]
                rev_dims = set(dmap.values())
                for d in range(na.rank):
                    D = dmap[d]
                    for a, an in enumerate(self.n.axis_names):
                        A = self.h.axis_index(st.amap[an])
                        if na.matrix[d][a] != ha.matrix[D][A]:
                            self.failures.append(MapFailure(
                                "coeff_mismatch", ni, hi, "final recheck failed"))
                            return
                for D in range(ha.rank):
                    if D in rev_dims:
                        continue
                    for A, c in enumerate(ha.matrix[D]):
                        if c != 0 and self.h.axis_names[A] in mapped_h_axes:
                            self.failures.append(MapFailure(
                                "coeff_mismatch", ni, hi,
                                f"unmapped dim {ha.buffer}[{D}] varies with "
                                f"mapped axis {self.h.axis_names[A]}"))
                            return

        # 4. temp escape: needle temps must map to haystack buffers fully
        #    consumed inside the window (they will not be materialised).
        wset = set(window)
        for nb in self.n.buffers:
            if not nb.temp or nb.name not in st.bmap:
                continue
            hb = st.bmap[nb.name]
            if hb in self.h.outputs:
                self.failures.append(MapFailure(
                    "temp_escapes", detail=f"{hb} is a program output but maps "
                                           f"to needle temp {nb.name}"))
                return
            for si, s in enumerate(self.h.statements):
                if si in wset:
                    continue
                if hb in self.h.reads(s) or self.h.writes(s) == hb:
                    self.failures.append(MapFailure(
                        "temp_escapes", haystack_stmt=si,
                        detail=f"{hb} used outside window at stmt {si}"))
                    return

        # Outer axes: axes in the *window statements'* domains left unmapped —
        # the instruction is invoked once per point of their joint domain.
        window_axes: set[str] = set()
        for hi in window:
            s = self.h.statements[hi]
            for acc in (s.lhs, s.rhs):
                window_axes |= acc.axes_used(self.h.axis_names)
        outer = tuple(a.name for a in self.h.axes
                      if a.name in window_axes and a.name not in mapped_h_axes)
        self.results.append(InstrMapping(
            needle_name=self.n.name,
            stmt_map=window,
            buffer_map=tuple(sorted(st.bmap.items())),
            dim_map=tuple(sorted(
                (b, tuple(m[d] for d in range(len(m)))) for b, m in st.dmap.items())),
            axis_map=tuple(sorted(st.amap.items())),
            outer_axes=outer,
        ))


def map_program(haystack: Program, needle: Program,
                max_results: int = 32) -> MapResult:
    """Entry point: find all mappings of ``needle`` inside ``haystack``."""
    return Mapper(haystack, needle, max_results=max_results).run()
