"""repro_torch.fabric — multi-chip fabric modeling, collective lowering, and an
event-driven distributed schedule simulator.

The single-chip stack (mapper → instruction selection → static scheduler)
stops at one chip's memory hierarchy; this package adds the communication
layer the paper names alongside "instruction sets ... and memory
architectures":

  * ``topology``    — first-class fabric descriptions (1D ICI ring, 2D
                      torus, PCIe host tree) that generate multi-chip
                      ``SystemGraph``s and expose per-link bandwidth/latency;
  * ``partition``   — shard a GEMM/GRU ISAMIR program along m/n/k (or batch)
                      into per-chip subprograms plus the collectives each
                      choice implies, with a bit-exact re-materialization
                      contract against the single-chip oracle;
  * ``collectives`` — ring / bidirectional-ring all-gather, reduce-scatter
                      and all-reduce lowered to COPY streams over fabric
                      links, with closed-form cost models;
  * ``simulate``    — an event-driven simulator replaying per-chip static
                      schedules plus collective phases on per-link/per-core
                      timelines (``python -m repro_torch.fabric.simulate``).

``simulate`` is imported lazily (it pulls in ``repro_torch.search``); the other
modules are dependency-light and safe to import from ``core``.
"""
from .collectives import (ALGORITHMS, CollectiveStep, all_gather_time,
                          all_reduce_time, reduce_scatter_time)
from .partition import PartitionedProgram, partition_gemm, partition_gru
from .topology import Link, Topology, host_tree, make_topology, ring, torus

__all__ = [
    "ALGORITHMS", "CollectiveStep", "Link", "PartitionedProgram", "Topology",
    "all_gather_time", "all_reduce_time", "host_tree", "make_topology",
    "partition_gemm", "partition_gru", "reduce_scatter_time", "ring", "torus",
]
