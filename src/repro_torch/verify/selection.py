"""Layer 2 — instruction-selection legality (``sel.*`` rules).

A ``Selection`` must cover every haystack statement exactly once, its
``axis_map``/``buffer_map`` bindings must be injective over axes/buffers
that exist on both sides (the PR-4 role-keyed tile-plan fix showed role
confusion is a live bug class), and the approach's tiling knobs
(``tile_caps``, ``vmem_frac``) must be sane against the axis extents.
"""
from __future__ import annotations

from ..core.ir import Program
from ..core.isel import Selection
from .diagnostics import Diagnostic, diag


def verify_selection(sel: Selection, approach=None) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    prog: Program = sel.program
    n_stmts = len(prog.statements)
    axis_names = set(prog.axis_names)
    buf_names = {b.name for b in prog.buffers}

    # -- statement coverage: exactly once -----------------------------------
    cover: dict[int, int] = {}
    for si in sel.instrs:
        for hi in si.mapping.stmt_map:
            if hi < 0 or hi >= n_stmts:
                diags.append(diag(
                    "sel.coverage-gap",
                    f"{si.needle.name} covers statement index {hi} outside "
                    f"program range [0, {n_stmts - 1}]",
                    subject=si.needle.name, uid=hi))
                continue
            cover[hi] = cover.get(hi, 0) + 1
    for hi in range(n_stmts):
        n = cover.get(hi, 0)
        if n == 0 and hi not in sel.uncovered:
            diags.append(diag(
                "sel.coverage-gap",
                f"statement {hi} is covered by no instruction and not "
                f"declared uncovered", uid=hi))
        elif n > 1:
            diags.append(diag(
                "sel.coverage-overlap",
                f"statement {hi} is covered by {n} instructions", uid=hi))
    for hi in sel.uncovered:
        if cover.get(hi):
            diags.append(diag(
                "sel.coverage-overlap",
                f"statement {hi} is declared uncovered but covered by "
                f"{cover[hi]} instruction(s)", uid=hi))

    # -- per-instruction mapping consistency --------------------------------
    for idx, si in enumerate(sel.instrs):
        m = si.mapping
        needle_axes = {a.name for a in si.needle.axes}
        needle_bufs = {b.name for b in si.needle.buffers}
        seen_n: set[str] = set()
        seen_h: set[str] = set()
        for na, ha in m.axis_map:
            if na not in needle_axes:
                diags.append(diag(
                    "sel.axis-role",
                    f"instr {idx} ({si.needle.name}): axis_map binds "
                    f"unknown needle axis {na!r}",
                    subject=si.needle.name, uid=idx))
            if ha not in axis_names:
                diags.append(diag(
                    "sel.axis-role",
                    f"instr {idx} ({si.needle.name}): axis_map binds "
                    f"needle axis {na!r} to unknown haystack axis {ha!r}",
                    subject=si.needle.name, uid=idx))
            if na in seen_n or ha in seen_h:
                diags.append(diag(
                    "sel.axis-role",
                    f"instr {idx} ({si.needle.name}): axis_map is not "
                    f"injective at ({na!r} -> {ha!r})",
                    subject=si.needle.name, uid=idx))
            seen_n.add(na)
            seen_h.add(ha)
        for ha in m.outer_axes:
            if ha not in axis_names:
                diags.append(diag(
                    "sel.axis-role",
                    f"instr {idx} ({si.needle.name}): outer axis {ha!r} "
                    f"is not a program axis",
                    subject=si.needle.name, uid=idx))
            elif ha in seen_h:
                diags.append(diag(
                    "sel.axis-role",
                    f"instr {idx} ({si.needle.name}): axis {ha!r} is both "
                    f"mapped and outer", subject=si.needle.name, uid=idx))
        seen_hb: set[str] = set()
        for nb, hb in m.buffer_map:
            if nb not in needle_bufs:
                diags.append(diag(
                    "sel.buffer-map",
                    f"instr {idx} ({si.needle.name}): buffer_map binds "
                    f"unknown needle buffer {nb!r}",
                    subject=si.needle.name, uid=idx))
            if hb not in buf_names:
                diags.append(diag(
                    "sel.buffer-map",
                    f"instr {idx} ({si.needle.name}): buffer_map binds "
                    f"{nb!r} to unknown haystack buffer {hb!r}",
                    subject=si.needle.name, uid=idx))
            if hb in seen_hb:
                diags.append(diag(
                    "sel.buffer-map",
                    f"instr {idx} ({si.needle.name}): buffer_map is not "
                    f"injective at haystack buffer {hb!r}",
                    subject=si.needle.name, uid=idx))
            seen_hb.add(hb)

    # -- approach tiling knobs ----------------------------------------------
    if approach is not None:
        caps = getattr(approach, "tile_caps", None) or ()
        for role, cap in zip("ijk", caps):
            if cap is not None and (not isinstance(cap, int) or cap < 1):
                diags.append(diag(
                    "sel.tile-cap",
                    f"tile cap for role {role!r} is {cap!r}; must be a "
                    f"positive int or None", subject=role))
        frac = getattr(approach, "vmem_frac", 1.0)
        if not (0.0 < frac <= 1.0):
            diags.append(diag(
                "sel.tile-cap",
                f"vmem_frac {frac!r} outside (0, 1]", subject="vmem_frac"))
    return diags
