"""The graph compiler: ``KernelGraph`` → ``CompiledGraph``.

Every node's kernel program goes through the *existing* pass pipeline
(``compile.driver.compile_program``), so the graph tier adds no second
compilation path — it adds reuse and placement on top:

  * **dedupe** — nodes are keyed by their program fingerprint; N nodes with
    the same shape issue one compile (in-process memo + ``ArtifactCache``),
    and the stats record exactly how many compiles were saved;
  * **placement** — ``plan_placement`` decides which inter-kernel tensors
    stay resident in VMEM and which spill to HBM, greedily by liveness
    under a byte budget (half the VMEM by default: the kernels' own tile
    working sets use the other half, cf. ``Approach.vmem_frac``);
  * **schedule** — the node DAG plus the placement-implied DMA traffic
    replays on the event simulator (``fabric.simulate.simulate_kernel_graph``)
    for an end-to-end modeled makespan on one chip.

The resulting ``CompiledGraph`` serializes to JSON (graph + per-node
kernel payloads + placement + stats) and executes on the card
(``execute.py``): every ``pallas_gpu_gemm`` node is one K1 launch at the
compiled plan's tile; a ``stream`` node that starts with a GEMM (a fused
GEMM + epilogue, a biased projection) is one K1 launch, or one K2 launch
where a bias (and a K2 activation) follows, with the rest of its program
interpreted on the result; every other node runs its program through
``interpret_program`` — bit-exact against ``interpret_graph`` and the torch
reference (``repro_torch.models.traceable``) wherever the exactness bound
holds.  The default target is the port's, ``gpu_sm(8)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..compile.artifact import CompiledKernel
from ..compile.driver import compile_program
from ..core.instructions import tpu_isa
from ..compile.keys import program_fingerprint
from ..core.sysgraph import SystemGraph, gpu_sm
from .execute import execute_graph
from .ir import GRAPH_SCHEMA, GraphError, KernelGraph

#: fraction of VMEM the placement planner may fill with resident tensors
#: (the kernels' own tile working sets get the rest, cf. vmem_frac).
RESIDENCY_FRAC = 0.5


# --------------------------------------------------------------------------- #
# Inter-kernel buffer placement
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Placement:
    """Where each intermediate tensor lives between kernels."""

    locations: dict  # tensor -> "vmem" | "hbm"
    peak_vmem: int   # max simultaneously-resident bytes the plan commits
    budget: int

    def spilled(self) -> list[str]:
        return sorted(t for t, loc in self.locations.items() if loc == "hbm")

    def to_dict(self) -> dict:
        return {"locations": dict(self.locations),
                "peak_vmem": self.peak_vmem, "budget": self.budget}

    @classmethod
    def from_dict(cls, d: dict) -> "Placement":
        return cls(dict(d.get("locations", {})),
                   int(d.get("peak_vmem", 0)), int(d.get("budget", 0)))


def plan_placement(g: KernelGraph, budget: int) -> Placement:
    """Greedy liveness-aware VMEM residency for the graph's intermediates.

    Walks nodes in (topological) order keeping a resident set: a produced
    intermediate goes to VMEM if it fits under ``budget``, otherwise it
    spills to HBM; residents are freed after their last consumer.  Pure —
    no compilation involved — so the verifier's ``gra.capacity`` replay
    (``verify.graph.verify_placement``) can re-check any plan.
    """
    inter = set(g.intermediates())
    last_use = {}
    for i, node in enumerate(g.nodes):
        for t in node.consumed():
            if t in inter:
                last_use[t] = i
    locations: dict[str, str] = {}
    resident: dict[str, int] = {}
    used = peak = 0
    for i, node in enumerate(g.nodes):
        for t in node.produced():
            if t not in inter:
                continue
            nb = g.tensors[t].nbytes
            if t in last_use and used + nb <= budget:
                locations[t] = "vmem"
                resident[t] = nb
                used += nb
                peak = max(peak, used)
            else:
                locations[t] = "hbm"
        for t in [t for t, li in last_use.items()
                  if li <= i and t in resident]:
            used -= resident.pop(t)
    return Placement(locations, peak, budget)


def edge_bytes(g: KernelGraph) -> int:
    """Placement-independent inter-kernel traffic: every tensor is written
    once by its producer and read once per consumer (graph outputs count
    one boundary read).  Fusing an epilogue deletes its wire tensor, so
    this is the modeled-bytes number the fusion benchmarks assert on."""
    producers = g.producers()
    consumers = g.consumers()
    total = 0
    for t, spec in g.tensors.items():
        writes = 1 if t in producers else 0
        total += (writes + len(consumers.get(t, []))) * spec.nbytes
    return total


# --------------------------------------------------------------------------- #
# The CompiledGraph artifact
# --------------------------------------------------------------------------- #

GRAPH_ARTIFACT_SCHEMA = 1


@dataclass
class CompiledGraph:
    """Serializable result of compiling a whole ``KernelGraph``.

    ``kernels`` holds one ``CompiledKernel`` per *unique* program
    fingerprint; ``node_kernels`` maps every node onto its (shared)
    kernel.  ``execute`` reads only each kernel's ``lowering`` and the
    node's program, so a ``CompiledGraph`` read back by ``from_dict`` runs
    as it is; ``ensure_kernels`` reattaches the live selections/schedules
    a fresh compile carries (cache hits make that cheap).
    """

    name: str
    graph_fp: str
    kernels: dict = field(default_factory=dict)       # program fp -> kernel
    node_kernels: dict = field(default_factory=dict)  # node name -> program fp
    placement: Placement | None = None
    makespan: float = 0.0
    hbm_bytes: int = 0
    edge_bytes: int = 0
    stats: dict = field(default_factory=dict)
    decisions: list = field(default_factory=list)     # fusion decision dicts
    graph: KernelGraph | None = None
    #: each node's ``execute.gemm_step``, derived at the first ``execute``
    #: and not serialized
    steps: dict | None = field(default=None, init=False, repr=False,
                               compare=False)
    #: each CUDA device's ``execute.Replay``: the runs so far, then the
    #: captured CUDA graph with its static inputs, outputs and memory pool;
    #: not serialized, freed with the ``CompiledGraph``
    replays: dict = field(default_factory=dict, init=False, repr=False,
                          compare=False)

    # -- execution -----------------------------------------------------------
    def execute(self, inputs: dict, device=None,
                return_all: bool = False) -> dict:
        """Run the graph on ``device`` (default: the card; ``"cpu"`` runs
        the same dispatch on the kernels' plain versions; from the second
        call on a card, one CUDA graph replays it) — see
        ``execute.execute_graph``.  Returns torch tensors on the device."""
        return execute_graph(self, inputs, device=device,
                             return_all=return_all)

    def ensure_kernels(self, graph: SystemGraph | None = None, approach=None,
                       isa=None, *, cache=None, use_cache: bool = True):
        """Reattach live selections/schedules after deserialization by
        re-driving each unique program through the compiler (artifact-cache
        hits skip the expensive stages)."""
        if self.graph is None:
            raise GraphError("CompiledGraph has no graph attached")
        sysgraph = graph if graph is not None else gpu_sm(8)
        isa = list(isa) if isa else tpu_isa()
        for node in self.graph.nodes:
            fp = self.node_kernels[node.name]
            art = self.kernels[fp]
            if art.schedule is not None or art.program is not None:
                continue
            self.kernels[fp] = compile_program(
                node.program, sysgraph, approach, isa,
                allow_transforms=False, cache=cache, use_cache=use_cache,
                meta={"graph": self.name, "node": node.name})
        return self

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema": GRAPH_ARTIFACT_SCHEMA,
                "graph_schema": GRAPH_SCHEMA,
                "name": self.name, "graph_fp": self.graph_fp,
                "kernels": {fp: k.to_dict()
                            for fp, k in sorted(self.kernels.items())},
                "node_kernels": dict(self.node_kernels),
                "placement": (self.placement.to_dict()
                              if self.placement else None),
                "makespan": self.makespan, "hbm_bytes": self.hbm_bytes,
                "edge_bytes": self.edge_bytes, "stats": dict(self.stats),
                "decisions": list(self.decisions),
                "graph": self.graph.to_dict() if self.graph else None}

    @classmethod
    def from_dict(cls, d: dict) -> "CompiledGraph":
        return cls(
            name=d.get("name", ""), graph_fp=d.get("graph_fp", ""),
            kernels={fp: CompiledKernel.from_dict(k)
                     for fp, k in d.get("kernels", {}).items()},
            node_kernels=dict(d.get("node_kernels", {})),
            placement=(Placement.from_dict(d["placement"])
                       if d.get("placement") else None),
            makespan=float(d.get("makespan", 0.0)),
            hbm_bytes=int(d.get("hbm_bytes", 0)),
            edge_bytes=int(d.get("edge_bytes", 0)),
            stats=dict(d.get("stats", {})),
            decisions=list(d.get("decisions", [])),
            graph=(KernelGraph.from_dict(d["graph"])
                   if d.get("graph") else None))

    def summary(self) -> str:
        s = self.stats
        spills = len(self.placement.spilled()) if self.placement else 0
        return (f"{self.name}: {s.get('nodes', 0)} node(s) -> "
                f"{s.get('unique_programs', 0)} compile(s) "
                f"({s.get('cache_hits', 0)} cached), "
                f"{spills} spill(s), makespan={self.makespan:.3e}s, "
                f"hbm={self.hbm_bytes}B edge={self.edge_bytes}B")


# --------------------------------------------------------------------------- #
# The driver
# --------------------------------------------------------------------------- #


def compile_graph(g: KernelGraph, graph: SystemGraph | None = None,
                  approach=None, isa=None, *, cache=None,
                  use_cache: bool = True, vmem_budget: int | None = None,
                  decisions=None, verify: bool = True) -> CompiledGraph:
    """Compile every node of ``g`` through the kernel pipeline and assemble
    the graph-level artifact.  ``decisions`` (from ``fuse_epilogues``)
    rides along for provenance; ``vmem_budget`` defaults to
    ``RESIDENCY_FRAC`` of the chip's fastest memory."""
    g.validate()
    sysgraph = graph if graph is not None else gpu_sm(8)
    isa = list(isa) if isa else tpu_isa()
    vmem = max(sysgraph.memories.values(), key=lambda m: m.level)
    budget = (int(vmem.capacity * RESIDENCY_FRAC)
              if vmem_budget is None else int(vmem_budget))

    kernels: dict[str, CompiledKernel] = {}
    node_kernels: dict[str, str] = {}
    fresh = hits = 0
    for node in g.nodes:
        fp = program_fingerprint(node.program)
        node_kernels[node.name] = fp
        if fp in kernels:
            continue
        art = compile_program(node.program, sysgraph, approach, isa,
                              allow_transforms=False, cache=cache,
                              use_cache=use_cache, verify=verify,
                              meta={"graph": g.name, "node": node.name})
        kernels[fp] = art
        fresh += not art.from_cache
        hits += art.from_cache

    placement = plan_placement(g, budget)
    from ..fabric.simulate import simulate_kernel_graph
    sim = simulate_kernel_graph(
        g, {n.name: kernels[node_kernels[n.name]].cost for n in g.nodes},
        placement.locations, sysgraph)

    gemm_nodes = [n for n in g.nodes if n.kind in ("gemm", "fused")]
    stats = {
        "nodes": len(g.nodes),
        "unique_programs": len(kernels),
        "compiles_issued": len(kernels),
        "fresh_compiles": fresh,
        "cache_hits": hits,
        "dedupe": round(len(g.nodes) / max(1, len(kernels)), 3),
        "gemm_nodes": len(gemm_nodes),
        "unique_gemm_programs": len({node_kernels[n.name]
                                     for n in gemm_nodes}),
        "spilled": len(placement.spilled()),
        "sim_tasks": sim["n_tasks"],
    }
    return CompiledGraph(
        name=g.name, graph_fp=g.fingerprint(), kernels=kernels,
        node_kernels=node_kernels, placement=placement,
        makespan=sim["makespan"], hbm_bytes=sim["hbm_bytes"],
        edge_bytes=edge_bytes(g), stats=stats,
        decisions=[d.to_dict() for d in (decisions or [])], graph=g)
