"""``repro_torch.verify`` — the static analyzer, copied from the JAX
package's ``repro.verify``.

Each layer emits structured ``Diagnostic`` records (rule id, severity,
offending op/statement, message) instead of bare exceptions:

  1. **program**   (``prg.*``) — ISAMIR legality on ``core.ir`` Programs
  2. **selection** (``sel.*``) — exact statement coverage, axis/buffer-map
     role consistency, tiling-knob sanity
  3. **schedule**  (``sch.*``) — symbolic replay of ``Schedule.ops`` over
     versioned regions: RAW/WAR/WAW hazards, capacity, residency
  4. **fabric**    (``fab.*``) — collective/task-graph acyclicity and the
     sharded-output partition contract
  5. **graph**     (``gra.*``) — ``repro_torch.graph`` kernel-graph wiring,
     topology, per-node program health, and placement capacity
  6. **serve**     (``srv.*``) — ``repro_torch.serve`` run traces: KV-aware
     admission, bucket routing, frozen-replay fidelity, liveness

plus structural checks on cached artifact payloads (``art.*``).

``verify_compile`` is the strict pipeline entry (``VerifyPass``);
``verify_artifact`` checks a live ``CompiledKernel``; the mutation harness
(``repro_torch.verify.mutate``) proves each rule actually fires, and
``python -m repro_torch.verify`` (``cli.py``) sweeps the tune suites.
"""
from __future__ import annotations

from .artifact import verify_artifact_dict
from .diagnostics import (ERROR, RULES, WARNING, Diagnostic,
                          DiagnosticReport, VerifyError, diag)
from .fabric import (verify_collective, verify_fabric, verify_partition,
                     verify_task_graph)
from .graph import verify_graph, verify_placement
from .program import verify_program
from .schedule import verify_schedule
from .selection import verify_selection
from .serve import verify_replay, verify_serve_trace

__all__ = [
    "Diagnostic", "DiagnosticReport", "VerifyError", "RULES", "ERROR",
    "WARNING", "diag", "verify_program", "verify_selection",
    "verify_schedule", "verify_collective", "verify_partition",
    "verify_task_graph", "verify_fabric", "verify_artifact_dict",
    "verify_graph", "verify_placement", "verify_serve_trace",
    "verify_replay", "verify_compile", "verify_artifact",
]


def verify_compile(program=None, selection=None, schedule=None,
                   approach=None) -> DiagnosticReport:
    """Check whatever stages a compile has produced so far.  ``program``
    defaults to ``selection.program`` (the possibly-transformed haystack
    the later stages actually consume)."""
    report = DiagnosticReport()
    if program is None and selection is not None:
        program = selection.program
    if program is not None:
        report.extend(verify_program(program))
    if selection is not None:
        report.extend(verify_selection(selection, approach))
    if schedule is not None:
        report.extend(verify_schedule(schedule, approach))
    return report


def verify_artifact(art, approach=None) -> DiagnosticReport:
    """Check a ``CompiledKernel``: its serialized payload plus — when the
    live selection/schedule are attached — the full static stack."""
    report = DiagnosticReport(meta={"key": getattr(art, "key", "")})
    report.extend(verify_artifact_dict(art.to_dict()))
    sel = getattr(art, "selection", None)
    sched = getattr(art, "schedule", None)
    if sel is not None or sched is not None:
        report.extend(verify_compile(
            selection=sel, schedule=sched,
            approach=approach if approach is not None
            else getattr(art, "approach", None)).diagnostics)
    return report
