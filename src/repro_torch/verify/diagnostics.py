"""Structured diagnostics — the currency of the ``repro_torch.verify`` analyzer.

Every verifier layer (program / selection / schedule / fabric / artifact)
emits ``Diagnostic`` records instead of raising bare exceptions: a stable
*rule id*, a severity, the offending object (a ``ScheduledOp.uid``, a
statement index, a buffer or node name) and a human message.  A
``DiagnosticReport`` aggregates them per verification run; ``ok`` means *no
error-severity findings* (warnings surface but do not fail a compile).

Rule ids are namespaced by layer (``prg.*``, ``sel.*``, ``sch.*``,
``fab.*``, ``gra.*``, ``srv.*``, ``art.*``) and registered in ``RULES`` so
the CLI, the mutation harness and the README rule table all speak from one
source.
"""
from __future__ import annotations

from dataclasses import dataclass, field

ERROR = "error"
WARNING = "warning"

#: rule id -> one-line description (the README table renders this).
RULES: dict[str, str] = {
    # program verifier (verify/program.py)
    "prg.rank": "access rank must match the buffer's rank",
    "prg.axis": "access matrix width must match the declared axis count",
    "prg.bounds": "affine accesses must stay in-bounds under axis extents",
    "prg.temp-read": "temp buffers must be written before they are read",
    "prg.output-unwritten": "every declared output must be written",
    "prg.unknown-buffer": "accesses must name declared buffers",
    "prg.dtype": "buffer dtypes must be known to core/dtypes.py",
    # selection verifier (verify/selection.py)
    "sel.coverage-gap": "every statement must be covered by an instruction",
    "sel.coverage-overlap": "no statement may be covered twice",
    "sel.axis-role": "axis_map must be injective over existing axes",
    "sel.buffer-map": "buffer_map must bind existing needle/haystack buffers",
    "sel.tile-cap": "tile caps must be positive and vmem_frac in (0, 1]",
    # schedule sanitizer (verify/schedule.py)
    "sch.unknown-node": "ops must reference nodes present in the SystemGraph",
    "sch.device-instr": "a compute op's device must execute its needle",
    "sch.operand-missing": "a compute/copy reads a region not resident at "
                           "its source in any version (RAW hazard)",
    "sch.stale-read": "a compute/copy reads an out-of-date version of a "
                      "region (RAW hazard)",
    "sch.overlap-dirty": "a write overlaps an unreconciled dirty region "
                         "(WAW/WAR hazard)",
    "sch.stale-writeback": "a writeback carries a version older than the "
                           "latest",
    "sch.capacity": "a tile's operand working set must fit its device "
                    "memory",
    "sch.vmem-budget": "a tile's working set exceeds the approach's "
                       "staging-memory budget (vmem_frac)",
    "sch.output-not-home": "final output regions must reside at their home "
                           "memory in the latest version",
    "sch.residency": "final_residency must agree with the replayed state",
    "sch.tile-mismatch": "a schedule's per-instruction compute tiles must "
                         "match what the approach resolves for the "
                         "selection (stale incremental reuse)",
    # fabric checker (verify/fabric.py)
    "fab.cycle": "collective/task dependency graphs must be acyclic",
    "fab.unknown-dep": "tasks must depend only on known tasks",
    "fab.duplicate-task": "task ids must be unique",
    "fab.unreachable": "every chip must receive every chunk it is owed",
    "fab.chain-broken": "reduce chains must visit all chips exactly once",
    "fab.contract": "per-chip shards must satisfy the sharded-output "
                    "contract",
    # graph verifier (verify/graph.py)
    "gra.unknown-tensor": "node wiring must reference declared tensors and "
                          "program buffers",
    "gra.shape": "a wired tensor's shape must match its program buffer",
    "gra.dtype": "a wired tensor's dtype must match its program buffer",
    "gra.cycle": "nodes must only consume tensors produced earlier "
                 "(acyclic, topologically ordered)",
    "gra.duplicate-producer": "every tensor must have at most one producer",
    "gra.output": "graph outputs must be produced and wired output buffers "
                  "must be program outputs",
    "gra.node-program": "every node's kernel program must verify clean "
                        "(prg.* layer)",
    "gra.capacity": "vmem-resident live tensors must fit the placement "
                    "budget",
    # serving-trace checker (verify/serve.py)
    "srv.kv-budget": "admitted batches must respect the KV byte budget and "
                     "the batch cap",
    "srv.bucket-route": "every request must be served by its pad-up "
                        "lattice bucket",
    "srv.replay-drift": "a frozen schedule must replay to identical "
                        "per-request admit/completion times",
    "srv.starvation": "every arrived request must eventually be admitted "
                      "and complete",
    # artifact payload checks (cached loads, verify/artifact.py)
    "art.schema": "artifact payloads must carry the known schema/fields",
    "art.instr-plan": "tile plans must be role-consistent and positive",
    "art.cost": "artifact cost must be a finite non-negative number",
    "art.counts": "op counts must be non-negative integers",
    "art.lowering-target": "the lowering config must match the artifact's "
                           "target family (no gpu lowering on a tpu graph "
                           "or vice versa)",
}


@dataclass(frozen=True)
class Diagnostic:
    """One finding: rule id + severity + offending object + message."""

    rule: str
    message: str
    severity: str = ERROR
    layer: str = ""                 # prg | sel | sch | fab | art
    subject: str = ""               # buffer/axis/node/needle name
    uid: int | None = None          # ScheduledOp.uid or statement index

    def __post_init__(self):
        if not self.layer:
            object.__setattr__(self, "layer", self.rule.split(".", 1)[0])

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "severity": self.severity,
             "layer": self.layer, "message": self.message}
        if self.subject:
            d["subject"] = self.subject
        if self.uid is not None:
            d["uid"] = self.uid
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Diagnostic":
        return cls(rule=d["rule"], message=d.get("message", ""),
                   severity=d.get("severity", ERROR),
                   layer=d.get("layer", ""), subject=d.get("subject", ""),
                   uid=d.get("uid"))

    def __str__(self) -> str:
        loc = f" @{self.subject}" if self.subject else ""
        if self.uid is not None:
            loc += f" uid={self.uid}"
        return f"[{self.severity}] {self.rule}{loc}: {self.message}"


@dataclass
class DiagnosticReport:
    """All findings of one verification run."""

    diagnostics: list[Diagnostic] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def rules(self) -> list[str]:
        return [d.rule for d in self.diagnostics]

    def extend(self, diags) -> "DiagnosticReport":
        self.diagnostics.extend(diags)
        return self

    def to_dict(self) -> dict:
        return {"ok": self.ok,
                "errors": len(self.errors),
                "warnings": len(self.warnings),
                "diagnostics": [d.to_dict() for d in self.diagnostics],
                "meta": dict(self.meta)}

    @classmethod
    def from_dict(cls, d: dict) -> "DiagnosticReport":
        return cls(diagnostics=[Diagnostic.from_dict(x)
                                for x in d.get("diagnostics", [])],
                   meta=dict(d.get("meta", {})))

    def render(self, limit: int = 20) -> str:
        if not self.diagnostics:
            return "clean (0 diagnostics)"
        lines = [str(d) for d in self.diagnostics[:limit]]
        if len(self.diagnostics) > limit:
            lines.append(f"... and {len(self.diagnostics) - limit} more")
        return "\n".join(lines)


class VerifyError(RuntimeError):
    """Raised by strict verification entry points (``VerifyPass``)."""

    def __init__(self, report: DiagnosticReport, context: str = ""):
        self.report = report
        head = f"verification failed ({len(report.errors)} error(s))"
        if context:
            head += f" for {context}"
        super().__init__(head + ":\n" + report.render())


def diag(rule: str, message: str, *, severity: str = ERROR,
         subject: str = "", uid: int | None = None) -> Diagnostic:
    """Shorthand constructor that validates the rule id against ``RULES``."""
    if rule not in RULES:
        raise KeyError(f"unregistered verify rule {rule!r}")
    return Diagnostic(rule=rule, message=message, severity=severity,
                      subject=subject, uid=uid)
