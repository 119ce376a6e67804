"""Serving-trace checker (``srv.*``) — the analyzer layer for
``repro_torch.serve``.

A serve run serializes to a trace dict (``ServeResult.trace()``: request
records, per-iteration batches, params).  These checks replay the
*invariants* the online scheduler must have respected, independently of
the simulator that produced the trace — so a mutated/corrupted trace (or
a buggy scheduler) is caught from the artifact alone:

  * ``srv.kv-budget``   — per iteration, the running batch's KV bytes fit
    the budget and the batch cap;
  * ``srv.bucket-route``— every request sits in its pad-up lattice bucket;
  * ``srv.starvation``  — every request was admitted and completed;
  * ``srv.replay-drift``— (``verify_replay``) two traces of the same
    workload — e.g. an online run vs its frozen static replay — agree on
    every request's admit and completion time.
"""
from __future__ import annotations

from .diagnostics import Diagnostic, diag


def _requests(trace: dict) -> dict[int, dict]:
    return {int(r["rid"]): r for r in trace.get("requests", [])}


def verify_serve_trace(trace: dict) -> list[Diagnostic]:
    """Check one serve-run trace against the admission invariants."""
    diags: list[Diagnostic] = []
    reqs = _requests(trace)
    params = trace.get("params", {})
    kv_budget = int(params.get("kv_budget", 0))
    max_batch = int(params.get("max_batch", 0))
    buckets = sorted(int(b) for b in trace.get("buckets", []))

    # admission control: KV bytes + batch cap, per iteration
    for itrec in trace.get("iterations", []):
        running = [int(r) for r in itrec.get("running", [])]
        kv = sum(int(reqs[r]["kv_bytes"]) for r in running if r in reqs)
        if kv_budget and kv > kv_budget:
            diags.append(diag(
                "srv.kv-budget",
                f"iteration {itrec.get('i')} holds {kv} KV bytes over the "
                f"{kv_budget}-byte budget", subject=f"iter:{itrec.get('i')}"))
        if max_batch and len(running) > max_batch:
            diags.append(diag(
                "srv.kv-budget",
                f"iteration {itrec.get('i')} runs {len(running)} requests "
                f"over the batch cap {max_batch}",
                subject=f"iter:{itrec.get('i')}"))

    # bucket routing: pad-up to the smallest fitting lattice bucket
    for rid, r in sorted(reqs.items()):
        want = next((b for b in buckets if int(r["prompt_len"]) <= b), None)
        if want is None or int(r["bucket"]) != want:
            diags.append(diag(
                "srv.bucket-route",
                f"request {rid} (prompt {r['prompt_len']}) served at bucket "
                f"{r['bucket']}, expected {want}", subject=f"req:{rid}"))

    # liveness: every request admitted and completed
    for rid, r in sorted(reqs.items()):
        if r.get("admitted") is None or r.get("completed") is None:
            stage = "admitted" if r.get("admitted") is None else "completed"
            diags.append(diag(
                "srv.starvation",
                f"request {rid} was never {stage}", subject=f"req:{rid}"))
    return diags


def verify_replay(frozen: dict, online: dict) -> list[Diagnostic]:
    """Check a frozen-schedule replay against its originating online run:
    same requests, bit-identical admit and completion times."""
    diags: list[Diagnostic] = []
    fr, on = _requests(frozen), _requests(online)
    if set(fr) != set(on):
        missing = sorted(set(on) ^ set(fr))
        diags.append(diag(
            "srv.replay-drift",
            f"replay serves a different request set (mismatch: {missing})"))
        return diags
    for rid in sorted(fr):
        for field in ("admitted", "completed"):
            a, b = fr[rid].get(field), on[rid].get(field)
            if a != b:
                diags.append(diag(
                    "srv.replay-drift",
                    f"request {rid} {field} drifts: frozen={a} online={b}",
                    subject=f"req:{rid}"))
    return diags
