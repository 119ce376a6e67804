"""Layer 5 — cached-artifact payload checks (``art.*`` rules).

Structural validation of serialized ``CompiledKernel`` dicts before the
artifact cache hydrates them: schema/fields present, tile plans positive
and role-consistent with their ``axis_map``, cost finite and non-negative,
op counts non-negative ints.  Works on the raw JSON dict (no compile-layer
imports) so ``compile.cache`` can call it without an import cycle.
"""
from __future__ import annotations

import math

from .diagnostics import Diagnostic, diag

_REQUIRED = ("key", "cost", "instrs")


def verify_artifact_dict(d: dict) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    if not isinstance(d, dict):
        return [diag("art.schema", f"artifact payload is {type(d).__name__}, "
                     f"not a dict")]
    for fld in _REQUIRED:
        if fld not in d:
            diags.append(diag(
                "art.schema", f"artifact payload missing field {fld!r}",
                subject=fld))
    if diags:
        return diags

    cost = d.get("cost")
    if not isinstance(cost, (int, float)) or not math.isfinite(cost) \
            or cost < 0:
        diags.append(diag(
            "art.cost", f"artifact cost {cost!r} is not a finite "
            f"non-negative number", subject=str(d.get("key", ""))))

    for k, v in (d.get("counts") or {}).items():
        if not isinstance(v, int) or v < 0:
            diags.append(diag(
                "art.counts", f"op count {k!r} = {v!r} is not a "
                f"non-negative int", subject=str(k)))
    bm = d.get("bytes_moved", 0)
    if not isinstance(bm, int) or bm < 0:
        diags.append(diag(
            "art.counts", f"bytes_moved {bm!r} is not a non-negative int",
            subject="bytes_moved"))

    # Lowering configs are target-family-specific: a gpu-shaped config on a
    # tpu/paper artifact (or the reverse) means keys got crossed somewhere
    # upstream — exactly the corruption a shared cache file would show.
    lowering = d.get("lowering") or {}
    kind = lowering.get("kind", "") if isinstance(lowering, dict) else ""
    gname = str(d.get("graph_name", ""))
    gpu_graph = gname.startswith("gpu")
    if kind == "pallas_gpu_gemm" and gname and not gpu_graph:
        diags.append(diag(
            "art.lowering-target",
            f"gpu lowering config {kind!r} on non-gpu graph {gname!r}",
            subject=gname))
    elif kind == "pallas_gemm" and gpu_graph:
        diags.append(diag(
            "art.lowering-target",
            f"tpu lowering config {kind!r} on gpu graph {gname!r}",
            subject=gname))
    if kind == "pallas_gpu_gemm":
        smem = lowering.get("smem_bytes")
        if not isinstance(smem, int) or smem < 1:
            diags.append(diag(
                "art.lowering-target",
                f"gpu lowering config must carry positive smem_bytes, got "
                f"{smem!r}", subject=gname))

    for i, p in enumerate(d.get("instrs") or ()):
        if not isinstance(p, dict) or "needle" not in p:
            diags.append(diag(
                "art.instr-plan", f"instr plan {i} is malformed "
                f"(missing needle)", uid=i))
            continue
        roles = [a for a, _ in p.get("axis_map", [])]
        for axis, size in p.get("tile", []):
            if axis not in roles:
                diags.append(diag(
                    "art.instr-plan",
                    f"instr plan {i} ({p['needle']}): tile axis {axis!r} "
                    f"is not a mapped role {roles}", subject=p["needle"],
                    uid=i))
            if not isinstance(size, int) or size < 1:
                diags.append(diag(
                    "art.instr-plan",
                    f"instr plan {i} ({p['needle']}): tile size {size!r} "
                    f"for axis {axis!r} must be a positive int",
                    subject=p["needle"], uid=i))
        calls = p.get("calls", 1)
        if not isinstance(calls, int) or calls < 1:
            diags.append(diag(
                "art.instr-plan",
                f"instr plan {i} ({p['needle']}): calls {calls!r} must be "
                f"a positive int", subject=p["needle"], uid=i))
    return diags
