"""System description graph (paper Section 3.2).

The machine is described as a graph of *compute nodes* (which instructions
they execute, out of which memory), *memory nodes* (capacity, level), and
*data-movement edges* (bandwidth/latency, which device issues the copy).
Nodes are stateful during scheduling: memory nodes track resident buffer
copies, compute nodes accumulate their instruction streams — the graph is the
hardware abstraction layer the static scheduler dry-runs against.

One factory is provided:

  * ``gpu_sm(n_sms)`` — the GPU target: one HBM3 module feeding thread-block
    clusters of SMs, each cluster staging through its distributed shared
    memory, with NVLink-class links between clusters when ``n_sms > 1``.

Memories carry a *role* (``host`` / ``global`` / ``staging``) so budget and
capacity logic — the scheduler's tile budget, the verifier's working-set
rules — reads the target's structure instead of hardcoding well-known TPU
names; ``resolve_target`` maps the CLI ``--target`` names onto factories.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

#: memory level -> default role.  ``host`` is system memory, ``global`` is
#: the device-wide store (HBM), ``staging`` is the explicitly managed
#: close-to-compute tier (TPU VMEM, GPU shared memory, register files) that
#: tile working sets are budgeted against.
_LEVEL_ROLES = {0: "host", 1: "global", 2: "staging"}


@dataclass(frozen=True)
class MemoryNode:
    name: str
    capacity: int                  # bytes
    level: int                     # 0 = host/system memory, larger = closer
    role: str = ""                 # host | global | staging (default: level)

    def __post_init__(self):
        if not self.role:
            object.__setattr__(
                self, "role", _LEVEL_ROLES.get(self.level, "staging"))


@dataclass(frozen=True)
class ComputeNode:
    name: str
    memory: str                    # the memory node operands must reside in
    instructions: frozenset[str]   # needle-name prefixes it can execute
    flops_per_sec: float
    matmul_tile: tuple[int, int, int] = (128, 128, 128)
    vector_lanes: int = 8 * 128    # VPU elements per cycle
    clock_hz: float = 0.94e9

    def executes(self, needle_name: str) -> bool:
        return any(needle_name.startswith(p) for p in self.instructions)


@dataclass(frozen=True)
class MoveEdge:
    src: str
    dst: str
    bandwidth: float               # bytes / sec
    latency: float                 # sec per transfer issue
    issuer: str = "host"           # device that emits the copy instruction


@dataclass
class SystemGraph:
    name: str
    memories: dict[str, MemoryNode] = field(default_factory=dict)
    computes: dict[str, ComputeNode] = field(default_factory=dict)
    edges: list[MoveEdge] = field(default_factory=list)
    family: str = "generic"        # tpu | gpu | paper | generic

    # -- construction -------------------------------------------------------
    def add_memory(self, name: str, capacity: int, level: int,
                   role: str = "") -> None:
        self.memories[name] = MemoryNode(name, capacity, level, role)

    def add_compute(self, name: str, memory: str, instructions, flops: float,
                    **kw) -> None:
        self.computes[name] = ComputeNode(name, memory, frozenset(instructions),
                                          flops, **kw)

    def add_edge(self, src: str, dst: str, bandwidth: float,
                 latency: float = 1e-6, issuer: str = "host",
                 bidirectional: bool = True,
                 rev_issuer: str | None = None) -> None:
        """Add a movement edge (and, by default, its reverse).

        ``issuer`` is the device that emits the forward copy; the reverse
        copy is emitted by ``rev_issuer`` when given (a pull-style DMA is
        issued by the *receiving* side, so the two directions generally
        have different issuers) and falls back to ``issuer`` otherwise.
        """
        self.edges.append(MoveEdge(src, dst, bandwidth, latency, issuer))
        if bidirectional:
            self.edges.append(MoveEdge(dst, src, bandwidth, latency,
                                       rev_issuer or issuer))

    # -- queries --------------------------------------------------------------
    def min_matmul_tile(self) -> tuple[int, int, int]:
        """The smallest hardware matmul tile across compute nodes (lexico
        min; all real graphs have uniform tiles).  The single definition
        behind the search space's tile choices and the learned cost model's
        tile features — they must agree on what "1x the hw tile" means."""
        tiles = {c.matmul_tile for c in self.computes.values()}
        return min(tiles) if tiles else (128, 128, 128)

    def edge(self, src: str, dst: str) -> MoveEdge:
        for e in self.edges:
            if e.src == src and e.dst == dst:
                return e
        raise KeyError(f"no edge {src} -> {dst}")

    def out_edges(self, src: str) -> list[MoveEdge]:
        return [e for e in self.edges if e.src == src]

    def shortest_path(self, src: str, dst: str,
                      nbytes: int = 1 << 20) -> list[MoveEdge]:
        """Min-cost path by modeled transfer time of ``nbytes`` (paper 3.5:
        'simply finding a shortest-path tends to work relatively well')."""
        if src == dst:
            return []
        dist = {src: 0.0}
        prev: dict[str, MoveEdge] = {}
        pq = [(0.0, src)]
        while pq:
            d, u = heapq.heappop(pq)
            if u == dst:
                break
            if d > dist.get(u, float("inf")):
                continue
            for e in self.out_edges(u):
                nd = d + e.latency + nbytes / e.bandwidth
                if nd < dist.get(e.dst, float("inf")):
                    dist[e.dst] = nd
                    prev[e.dst] = e
                    heapq.heappush(pq, (nd, e.dst))
        if dst not in prev:
            raise KeyError(f"no path {src} -> {dst}")
        path, cur = [], dst
        while cur != src:
            e = prev[cur]
            path.append(e)
            cur = e.src
        return list(reversed(path))

    def compute_nodes_for(self, needle_name: str) -> list[ComputeNode]:
        return [c for c in self.computes.values() if c.executes(needle_name)]

    def memory_of(self, compute: str) -> MemoryNode:
        return self.memories[self.computes[compute].memory]

    def staging_budget(self, devices=None) -> int | None:
        """Per-tile working-set budget: a third of the smallest staging
        memory feeding ``devices`` (default: all compute nodes).  The /3
        leaves headroom for resident weights and in-flight copies next to
        the active tile; the single definition behind the scheduler's
        tile shapes, the evaluators' feasibility guards and the tuner's
        cache records — whatever the staging tier is called (TPU VMEM,
        GPU shared memory, register files)."""
        devs = list(self.computes.values()) if devices is None \
            else list(devices)
        caps = [self.memories[d.memory].capacity for d in devs
                if d.memory in self.memories]
        return min(caps) // 3 if caps else None


# --------------------------------------------------------------------------- #
# Hardware constants (GPU) — NVIDIA H100 SXM data-sheet peaks at 700 W, not
# measurements; GPU_SMS_PER_CLUSTER and GPU_CLOCK are modelling choices
# --------------------------------------------------------------------------- #

GPU_PEAK_FLOPS = 989e12        # bf16 dense FLOP/s, whole device
GPU_HBM_BW = 3.35e12           # HBM3 bytes/s, whole device
GPU_HBM_BYTES = 80 << 30
GPU_SMEM_BYTES = 228 << 10     # usable shared memory per SM
GPU_SMS_PER_CLUSTER = 16       # thread-block cluster size (distributed smem)
GPU_NVLINK_BW = 450e9          # bytes/s per direction, NVLink-class
GPU_PCIE_BW = 64e9             # host link, PCIe gen5 x16
GPU_CLOCK = 1.8e9


def gpu_sm(n_sms: int = 8, host_mem: int = 512 << 30) -> SystemGraph:
    """A modeled GPU as a system graph: ``n_sms`` thread-block clusters.

    The schedulable compute unit is a *cluster* of ``GPU_SMS_PER_CLUSTER``
    SMs cooperating through distributed shared memory (the warp/SM tier
    below it is implicit in the cluster's aggregate FLOP rate), so tile
    working sets are budgeted against the cluster-wide staging capacity
    rather than one SM's 228 KB — the same explicitly managed three-level
    shape (host -> global HBM -> staging) the scheduler already dry-runs,
    with GPU capacities and bandwidths:

      * one HBM3 module (``hbm0``, level 1, role ``global``) shared by all
        clusters; each cluster's load path gets an equal slice of the
        aggregate HBM bandwidth,
      * per-cluster shared memory (``smem{c}``, level 2, role ``staging``),
      * NVLink-class cluster-to-cluster ring links when ``n_sms > 1`` (the
        DSM/switch fabric, which the fabric layer can extend device-to-
        device).

    Clusters execute the same needle prefixes as every other target — the
    paper's portability claim is that mapping/selection are target-agnostic
    and only scheduling/lowering consult the machine.
    """
    g = SystemGraph(f"gpu_sm_x{n_sms}", family="gpu")
    g.add_memory("host", host_mem, level=0)
    g.add_memory("hbm0", GPU_HBM_BYTES, level=1)
    g.add_edge("host", "hbm0", bandwidth=GPU_PCIE_BW, latency=2e-6,
               issuer="host", rev_issuer="sm0")
    cluster_flops = GPU_PEAK_FLOPS / 8          # ~8 clusters per device
    cluster_smem = GPU_SMS_PER_CLUSTER * GPU_SMEM_BYTES
    for c in range(n_sms):
        smem = f"smem{c}"
        g.add_memory(smem, cluster_smem, level=2)
        # TMA loads: every cluster gets an equal share of HBM bandwidth.
        g.add_edge("hbm0", smem, bandwidth=GPU_HBM_BW / n_sms, latency=5e-7,
                   issuer=f"sm{c}")
        g.add_compute(
            f"sm{c}", smem,
            {"mxu.", "vpu.", "fused."},
            flops=cluster_flops,
            # cluster-wide WGMMA tile: 16 SMs x (64, 64) warpgroup output
            # panels arranged 4x4, reduction in k=32 steps
            matmul_tile=(256, 256, 32),
            vector_lanes=GPU_SMS_PER_CLUSTER * 128,
            clock_hz=GPU_CLOCK)
    if n_sms > 1:
        # DSM / NVLink-class ring between neighbouring clusters, each
        # direction issued by the receiving side (pull-style TMA).
        for c in range(n_sms):
            nxt = (c + 1) % n_sms
            if n_sms == 2 and c == 1:
                break               # a 2-ring has one physical link
            g.add_edge(f"smem{c}", f"smem{nxt}", bandwidth=GPU_NVLINK_BW,
                       latency=3e-7, issuer=f"sm{nxt}",
                       rev_issuer=f"sm{c}")
    return g


# --------------------------------------------------------------------------- #
# Target registry — the CLI ``--target`` vocabulary
# --------------------------------------------------------------------------- #

#: canonical target name -> zero-arg factory for the default single-device
#: graph.
TARGETS: dict[str, object] = {
    "gpu_sm": lambda: gpu_sm(8),
}

#: short spellings accepted by resolve_target.
TARGET_ALIASES = {"gpu": "gpu_sm"}


def resolve_target(name: str) -> SystemGraph:
    """The default SystemGraph for a ``--target`` name (aliases accepted)."""
    canon = TARGET_ALIASES.get(name, name)
    try:
        return TARGETS[canon]()
    except KeyError:
        raise KeyError(
            f"unknown target {name!r}; known: "
            f"{sorted(set(TARGETS) | set(TARGET_ALIASES))}") from None
