"""Instruction selection (paper Section 2.4).

The mapper typically produces several candidate mappings per needle (anything
matmul-mappable is also dot-mappable, fused instructions overlap their
unfused parts, ...).  Following the paper, the default heuristic picks the
non-overlapping set that minimises the number of final instruction *calls* —
largest statement windows first, ties broken by fewest invocations.

The full decision is routed through the Approach interface (approach.py) so
cost models / search can replace the heuristic.
"""
from __future__ import annotations

from dataclasses import dataclass

from .ir import Program
from .mapper import InstrMapping, map_program
from .transforms import search_mappings


@dataclass(frozen=True)
class SelectedInstr:
    """One chosen instruction instance covering ``mapping.stmt_map``."""

    needle: Program
    mapping: InstrMapping

    @property
    def first_stmt(self) -> int:
        return self.mapping.stmt_map[0]

    @property
    def last_stmt(self) -> int:
        return self.mapping.stmt_map[-1]


@dataclass
class Selection:
    """Complete cover of a program by instructions (+ any uncovered stmts)."""

    program: Program          # possibly transformed haystack
    steps: tuple             # transforms applied to reach `program`
    instrs: list[SelectedInstr]
    uncovered: tuple[int, ...]

    @property
    def complete(self) -> bool:
        return not self.uncovered

    def total_calls(self) -> int:
        return sum(si.mapping.calls(self.program) for si in self.instrs)


def candidate_instructions(prog: Program, isa: list[Program],
                           max_per_needle: int = 64) -> list[SelectedInstr]:
    """The mapping stage: every way an ISA needle identifies inside ``prog``,
    deduplicated to the fewest-calls mapping per statement window.  This is
    the ``Map`` pass of the compilation pipeline (``repro.compile``);
    ``select_from_candidates`` turns its output into a cover."""
    cands: list[SelectedInstr] = []
    for needle in isa:
        res = map_program(prog, needle, max_results=max_per_needle)
        best_per_window: dict[tuple[int, ...], InstrMapping] = {}
        for m in res.mappings:
            prev = best_per_window.get(m.stmt_map)
            if prev is None or m.calls(prog) < prev.calls(prog):
                best_per_window[m.stmt_map] = m
        cands.extend(SelectedInstr(needle, m) for m in best_per_window.values())
    return cands


def select_from_candidates(prog: Program, cands: list[SelectedInstr],
                           isa: list[Program],
                           allow_transforms: bool = True,
                           approach=None) -> Selection:
    """The selection stage: cover ``prog`` from pre-computed mapping
    candidates (the ``Select`` pass of the compilation pipeline).

    If a high-value needle (one covering multi-statement windows, e.g. the
    MXU matmul) has no direct mapping and ``allow_transforms`` is set, the
    feedback-guided search (transforms.py) is consulted and the resulting
    selections are compared by (completeness, total calls, #instructions) —
    the paper's minimum-instruction heuristic extended across transform paths.
    """
    chosen, covered = _greedy_cover(prog, cands, approach)
    uncovered = tuple(i for i in range(len(prog.statements)) if i not in covered)
    best = Selection(prog, (), chosen, uncovered)
    if not allow_transforms:
        return best

    def quality(sel: Selection):
        return (len(sel.uncovered), sel.total_calls(), len(sel.instrs))

    # Needles with multi-statement windows that found nothing directly are
    # candidates for unblocking via IR transformations.
    mapped_needles = {si.needle.name for si in chosen}
    for needle in isa:
        if len(needle.statements) < 2 or needle.name in mapped_needles:
            continue
        for r in search_mappings(prog, needle, max_depth=3):
            if not r.steps:
                continue
            sel2 = select_instructions(r.program, isa, allow_transforms=False,
                                       approach=approach)
            sel2 = Selection(sel2.program, tuple(r.steps), sel2.instrs,
                             sel2.uncovered)
            if quality(sel2) < quality(best):
                best = sel2
    return best


def select_instructions(prog: Program, isa: list[Program],
                        allow_transforms: bool = True,
                        approach=None) -> Selection:
    """Map + select in one call (the historical entry point): compute the
    mapping candidates, then cover the program with them."""
    return select_from_candidates(prog, candidate_instructions(prog, isa),
                                  isa, allow_transforms=allow_transforms,
                                  approach=approach)


def _greedy_cover(prog: Program, cands: list[SelectedInstr], approach=None):
    """Paper heuristic: minimum number of final instructions — widest window
    first, then fewest calls.  An Approach can override the ranking."""
    if approach is not None:
        def key(si: SelectedInstr):
            return approach.rank_instruction(si, prog)
    else:
        def key(si: SelectedInstr):
            return (-len(si.mapping.stmt_map), si.mapping.calls(prog))
    chosen: list[SelectedInstr] = []
    covered: set[int] = set()
    for si in sorted(cands, key=key):
        s = set(si.mapping.stmt_map)
        if s & covered:
            continue
        covered |= s
        chosen.append(si)
    chosen.sort(key=lambda si: si.first_stmt)
    return chosen, covered
