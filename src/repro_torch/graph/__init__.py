"""``repro_torch.graph`` — the whole-model tier above ``repro_torch.compile``.

A ``KernelGraph`` (``ir.py``) is a DAG of kernel-level ISAMIR programs
connected by named tensor edges; tracers (``trace.py``) lower model
configs into one; the fusion pass (``fuse.py``) folds elementwise
epilogues into their producer GEMMs; and the graph compiler
(``compile.py``) drives every node through the existing pass pipeline —
deduped via the artifact cache — into a serializable ``CompiledGraph``
with an inter-kernel buffer placement and an event-simulated end-to-end
makespan.  ``execute.py`` runs a ``CompiledGraph`` on the card: its
``pallas_gpu_gemm`` nodes through K1 (``kernels/gemm.py::gemm``), its
instruction-stream nodes through ``interpret_program``.
"""
from __future__ import annotations

from .compile import (CompiledGraph, Placement, compile_graph, edge_bytes,
                      plan_placement)
from .execute import execute_graph, interpret_program
from .fuse import FusionDecision, fuse_epilogues
from .ir import (GRAPH_SCHEMA, GraphBuilder, GraphError, GraphNode,
                 KernelGraph, TensorSpec, interpret_graph, program_from_dict,
                 program_to_dict)
from .trace import (EXACT_F32_BOUND, assert_exactness_bound, block_inputs,
                    trace_block, trace_gru_chain)

__all__ = [
    "GRAPH_SCHEMA", "GraphBuilder", "GraphError", "GraphNode", "KernelGraph",
    "TensorSpec", "interpret_graph", "program_to_dict", "program_from_dict",
    "trace_block", "trace_gru_chain", "block_inputs",
    "assert_exactness_bound", "EXACT_F32_BOUND", "FusionDecision",
    "fuse_epilogues", "CompiledGraph", "Placement", "compile_graph",
    "plan_placement", "edge_bytes", "execute_graph", "interpret_program",
]
