"""Graph-layer verifier (``gra.*``) — the tolerant, diagnostic-emitting
twin of ``repro_torch.graph.ir.KernelGraph.validate``.

``validate()`` raises on first violation (the constructor fast path);
``verify_graph`` keeps going and reports *every* finding, duck-typing the
graph so corrupted objects (bad serialization, a buggy pass, the mutation
harness's ``object.__setattr__`` edits) cannot crash the analyzer before
it has had its say.  ``verify_placement`` replays the liveness walk of
``repro_torch.graph.compile.plan_placement`` against any claimed placement and
budget — the graph-tier capacity rule, analogous to ``sch.capacity`` one
layer down.
"""
from __future__ import annotations

from .diagnostics import Diagnostic, diag
from .program import verify_program


def verify_graph(g) -> list[Diagnostic]:
    """Structural checks on a ``KernelGraph``: wiring, shapes/dtypes,
    topological order, producer uniqueness, output coverage, and a
    ``prg.*`` sweep over every node's kernel program (summarized as
    ``gra.node-program`` so one graph finding names the offending node)."""
    diags: list[Diagnostic] = []
    known = set(g.tensors)
    for t in list(g.inputs) + list(g.outputs):
        if t not in known:
            diags.append(diag("gra.unknown-tensor",
                              f"graph boundary names unknown tensor {t!r}",
                              subject=t))
    produced: set[str] = set(g.inputs)
    producers: dict[str, str] = {}
    names: set[str] = set()
    for node in g.nodes:
        if node.name in names:
            diags.append(diag("gra.duplicate-producer",
                              f"duplicate node name {node.name!r}",
                              subject=node.name))
        names.add(node.name)
        for buf, t in tuple(node.inputs) + tuple(node.outputs):
            if t not in known:
                diags.append(diag("gra.unknown-tensor",
                                  f"{node.name}: wires unknown tensor {t!r}",
                                  subject=node.name))
                continue
            try:
                b = node.program.buffer(buf)
            except KeyError:
                diags.append(diag("gra.unknown-tensor",
                                  f"{node.name}: wires unknown buffer "
                                  f"{buf!r}", subject=node.name))
                continue
            spec = g.tensors[t]
            if tuple(b.shape) != tuple(spec.shape):
                diags.append(diag("gra.shape",
                                  f"{node.name}: buffer {buf} shape "
                                  f"{tuple(b.shape)} != tensor {t} shape "
                                  f"{tuple(spec.shape)}", subject=node.name))
            if b.dtype != spec.dtype:
                diags.append(diag("gra.dtype",
                                  f"{node.name}: buffer {buf} dtype "
                                  f"{b.dtype} != tensor {t} dtype "
                                  f"{spec.dtype}", subject=node.name))
        for _, t in node.inputs:
            if t in known and t not in produced:
                diags.append(diag("gra.cycle",
                                  f"{node.name}: consumes {t!r} before it "
                                  f"is produced (cycle or bad topological "
                                  f"order)", subject=node.name))
        for buf, t in node.outputs:
            if t in produced:
                diags.append(diag(
                    "gra.duplicate-producer",
                    f"{node.name}: tensor {t!r} already has a producer "
                    f"({producers.get(t, 'graph input')})", subject=t))
            if buf not in node.program.outputs:
                diags.append(diag("gra.output",
                                  f"{node.name}: wired output buffer "
                                  f"{buf!r} is not a program output",
                                  subject=node.name))
            produced.add(t)
            producers[t] = node.name
        prg = [d for d in verify_program(node.program)
               if d.severity == "error"]
        if prg:
            rules = sorted({d.rule for d in prg})
            diags.append(diag("gra.node-program",
                              f"{node.name}: program "
                              f"{node.program.name!r} fails "
                              f"{', '.join(rules)}", subject=node.name))
    for t in g.outputs:
        if t in known and t not in produced:
            diags.append(diag("gra.output",
                              f"graph output {t!r} is never produced",
                              subject=t))
    return diags


def verify_placement(g, locations: dict, budget: int) -> list[Diagnostic]:
    """Replay the liveness walk against a claimed placement: at no point may
    the VMEM-resident live set exceed ``budget``, and every intermediate
    must have a legal location."""
    diags: list[Diagnostic] = []
    inter = set(g.intermediates())
    for t in inter:
        loc = locations.get(t)
        if loc not in ("vmem", "hbm"):
            diags.append(diag("gra.capacity",
                              f"intermediate {t!r} has no legal placement "
                              f"(got {loc!r})", subject=t))
    last_use: dict[str, int] = {}
    for i, node in enumerate(g.nodes):
        for t in node.consumed():
            if t in inter:
                last_use[t] = i
    resident: dict[str, int] = {}
    used = 0
    for i, node in enumerate(g.nodes):
        for t in node.produced():
            if t in inter and locations.get(t) == "vmem":
                nb = g.tensors[t].nbytes
                resident[t] = nb
                used += nb
                if used > budget:
                    diags.append(diag(
                        "gra.capacity",
                        f"at node {node.name}: resident set {used}B "
                        f"exceeds budget {budget}B placing {t!r}",
                        subject=node.name))
        for t in [t for t, li in last_use.items()
                  if li <= i and t in resident]:
            used -= resident.pop(t)
    return diags
