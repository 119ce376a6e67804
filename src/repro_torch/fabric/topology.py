"""First-class fabric descriptions (ICI ring, 2D torus, PCIe host tree).

A ``Topology`` names the chips of a multi-chip system and the directed
*fabric links* between them.  It is the single source of truth for
inter-chip wiring: ``build_graph()`` produces the multi-chip
``SystemGraph`` the scheduler/simulator dry-runs against (replacing the
ad-hoc ring wiring ``sysgraph.tpu_v5e`` used to hard-code), and
``path()``/``ring_order`` feed the collective lowering in
``collectives.py``.

Bandwidth model: a v5e chip has ``ICI_PORTS_PER_CHIP`` ICI ports of
``V5E_ICI_BW`` each (per direction).  A topology splits the ports evenly
across its distinct neighbours and *bonds* them, so a 1D ring (2
neighbours) gets 2x the per-port bandwidth on each link, a 2-chip ring
(1 neighbour) bonds all 4 ports, and a full 2D torus (4 neighbours) runs
one port per link.  The host tree has no ICI at all — chips talk through
host memory over PCIe, which is exactly why it loses the scaling sweeps.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.sysgraph import V5E_ICI_BW, SystemGraph, add_v5e_chip

#: ICI ports per chip (v5e: 4), each V5E_ICI_BW per direction.
ICI_PORTS_PER_CHIP = 4

#: Default per-hop ICI issue latency (sec).
ICI_LATENCY = 1e-6

#: PCIe bandwidth / latency for host-tree fabrics (matches sysgraph's
#: host<->HBM edges).
PCIE_BW = 32e9
PCIE_LATENCY = 2e-6


@dataclass(frozen=True)
class Link:
    """One directed fabric link.  Endpoints are ``"chip<i>"`` or ``"host"``."""

    src: str
    dst: str
    bandwidth: float               # bytes / sec
    latency: float                 # sec per transfer issue


def _chip(i: int) -> str:
    return f"chip{i}"


@dataclass(frozen=True)
class Topology:
    """A named fabric over ``n_chips`` v5e chips.

    ``ring_order`` is a communication cycle over the chips used by the
    ring-based collective algorithms; consecutive chips are adjacent in
    the fabric whenever the topology admits it (ring: trivially; torus:
    a snake cycle), otherwise ``path()`` routes each logical hop over
    multiple physical links (host tree: every hop goes through host).
    """

    name: str
    n_chips: int
    links: tuple[Link, ...]
    ring_order: tuple[int, ...] = ()

    def __post_init__(self):
        if not self.ring_order:
            object.__setattr__(self, "ring_order", tuple(range(self.n_chips)))

    # -- queries --------------------------------------------------------------
    def link(self, src: str, dst: str) -> Link:
        for l in self.links:
            if l.src == src and l.dst == dst:
                return l
        raise KeyError(f"no fabric link {src} -> {dst}")

    def neighbors(self, node: str) -> list[str]:
        return [l.dst for l in self.links if l.src == node]

    def path(self, src_chip: int, dst_chip: int) -> list[Link]:
        """Fewest-hops route between two chips (BFS over fabric links)."""
        src, dst = _chip(src_chip), _chip(dst_chip)
        if src == dst:
            return []
        prev: dict[str, Link] = {}
        frontier, seen = [src], {src}
        while frontier and dst not in prev:
            nxt = []
            for u in frontier:
                for l in self.links:
                    if l.src == u and l.dst not in seen:
                        seen.add(l.dst)
                        prev[l.dst] = l
                        nxt.append(l.dst)
            frontier = nxt
        if dst not in prev:
            raise KeyError(f"no fabric path {src} -> {dst}")
        path, cur = [], dst
        while cur != src:
            l = prev[cur]
            path.append(l)
            cur = l.src
        return list(reversed(path))

    def min_link_bandwidth(self) -> float:
        chip_links = [l for l in self.links
                      if l.src != "host" and l.dst != "host"]
        return min((l.bandwidth for l in chip_links), default=PCIE_BW)

    # -- SystemGraph construction ---------------------------------------------
    def wire_ici(self, g: SystemGraph) -> None:
        """Add this topology's chip-to-chip links to an existing multi-chip
        graph as HBM<->HBM movement edges.  Each directed copy is issued by
        the *receiving* chip's core (pull-style ICI DMA) — the per-direction
        issuer the old ad-hoc wiring got wrong.  Host links are skipped
        (``add_v5e_chip`` already wires PCIe)."""
        for l in self.links:
            if l.src == "host" or l.dst == "host":
                continue
            a, b = int(l.src[4:]), int(l.dst[4:])
            g.add_edge(f"hbm{a}", f"hbm{b}", bandwidth=l.bandwidth,
                       latency=l.latency, issuer=f"core{b}",
                       bidirectional=False)

    def build_graph(self, host_mem: int = 512 << 30) -> SystemGraph:
        """The multi-chip SystemGraph: one v5e chip per fabric chip plus
        this topology's ICI edges."""
        g = SystemGraph(f"tpu_v5e_{self.name}")
        g.add_memory("host", host_mem, level=0)
        for c in range(self.n_chips):
            add_v5e_chip(g, c)
        self.wire_ici(g)
        return g

    @staticmethod
    def chip_graph() -> SystemGraph:
        """A single-chip graph for the per-chip static scheduler."""
        from ..core.sysgraph import tpu_v5e
        return tpu_v5e(1)


def _bond(n_neighbors: int) -> int:
    return max(1, ICI_PORTS_PER_CHIP // max(1, n_neighbors))


def ring(n_chips: int, ici_bw: float = V5E_ICI_BW,
         latency: float = ICI_LATENCY) -> Topology:
    """1D bidirectional ICI ring.  With 2 distinct neighbours per chip the
    4 ports bond pairwise (2x per-port bandwidth per link); the degenerate
    2-chip ring bonds all 4 ports onto its single neighbour."""
    if n_chips < 1:
        raise ValueError("ring needs at least 1 chip")
    links: list[Link] = []
    if n_chips > 1:
        n_nb = 1 if n_chips == 2 else 2
        bw = _bond(n_nb) * ici_bw
        for i in range(n_chips):
            j = (i + 1) % n_chips
            links.append(Link(_chip(i), _chip(j), bw, latency))
            links.append(Link(_chip(j), _chip(i), bw, latency))
            if n_chips == 2:
                break                      # one bonded pair, both directions
    return Topology(f"ring{n_chips}", n_chips, tuple(links))


def torus(rows: int, cols: int, ici_bw: float = V5E_ICI_BW,
          latency: float = ICI_LATENCY) -> Topology:
    """2D torus (row-major chip ids).  Degenerate 1-wide dims collapse to a
    ring; 2-wide dims fold their wraparound onto the direct link (bonded).
    ``ring_order`` is the row-major snake cycle the ring collectives run
    over."""
    n = rows * cols
    if n < 1:
        raise ValueError("torus needs at least 1 chip")
    if rows == 1 or cols == 1:
        t = ring(n, ici_bw, latency)
        return Topology(f"torus{rows}x{cols}", n, t.links, t.ring_order)
    # Every chip fields 4 link endpoints (2 per dim, wraps included); 2-wide
    # dims fold both endpoints onto the same neighbour pair, which then
    # bonds the ports of both parallel cables.
    per_pair: dict[tuple[int, int], int] = {}
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for j in (r * cols + (c + 1) % cols, ((r + 1) % rows) * cols + c):
                if i == j:
                    continue
                pair = (min(i, j), max(i, j))
                per_pair[pair] = per_pair.get(pair, 0) + 1
    unit = ICI_PORTS_PER_CHIP / 4 * ici_bw     # ports spread over 4 endpoints
    links: list[Link] = []
    for (i, j), mult in sorted(per_pair.items()):
        bw = mult * unit
        links.append(Link(_chip(i), _chip(j), bw, latency))
        links.append(Link(_chip(j), _chip(i), bw, latency))
    # snake cycle: row-major, odd rows reversed; consecutive cells adjacent
    order: list[int] = []
    for r in range(rows):
        cs = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        order.extend(r * cols + c for c in cs)
    return Topology(f"torus{rows}x{cols}", n, tuple(links), tuple(order))


def host_tree(n_chips: int, pcie_bw: float = PCIE_BW,
              latency: float = PCIE_LATENCY) -> Topology:
    """No ICI: every chip hangs off the host over PCIe.  Collectives route
    every hop through host memory — the fabric that shows why direct
    interconnect matters."""
    links: list[Link] = []
    for i in range(n_chips):
        links.append(Link(_chip(i), "host", pcie_bw, latency))
        links.append(Link("host", _chip(i), pcie_bw, latency))
    return Topology(f"host{n_chips}", n_chips, tuple(links))


def make_topology(name: str, n_chips: int) -> Topology:
    """CLI dispatcher: ``ring`` | ``torus`` (squarest rows x cols factoring)
    | ``host``."""
    if name == "ring":
        return ring(n_chips)
    if name == "torus":
        rows = 1
        for r in range(int(n_chips ** 0.5), 0, -1):
            if n_chips % r == 0:
                rows = r
                break
        return torus(rows, n_chips // rows)
    if name == "host":
        return host_tree(n_chips)
    raise ValueError(f"unknown topology {name!r} (ring|torus|host)")
