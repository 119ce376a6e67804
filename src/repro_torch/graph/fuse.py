"""Epilogue fusion — fold elementwise nodes into their producer GEMM.

A candidate is an ``elementwise`` node whose *wire* input tensor is
produced by a ``gemm``/``fused`` node, is consumed by nobody else, and is
not a graph output.  The two kernel programs are composed with
``core.transforms.fuse_epilogue`` — the producer keeps its GEMM statements
and gains the consumer's elementwise tail on its output buffer, so
instruction selection covers the result with ``mxu.matmul`` + VPU needles
(or the ``fused.*`` needles when they match).  The wire tensor disappears
from the graph entirely: that is the modeled-bytes win the benchmarks and
the CI lane assert.

The pass runs to fixpoint, so chains fold fully: ``gemm → relu → add``
becomes one node.  Every decision is recorded (consumer, producer, tensor,
bytes saved) for the CLI report and the ``CompiledGraph`` artifact.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.ir import IRError
from ..core.transforms import fuse_epilogue
from .ir import GraphNode, KernelGraph

FUSABLE_PRODUCERS = ("gemm", "fused")


@dataclass(frozen=True)
class FusionDecision:
    consumer: str          # elementwise node folded away
    producer: str          # node it was folded into
    tensor: str            # wire tensor eliminated from the graph
    saved_bytes: int       # the wire tensor's size (write + one read)

    def to_dict(self) -> dict:
        return {"consumer": self.consumer, "producer": self.producer,
                "tensor": self.tensor, "saved_bytes": self.saved_bytes}


def _fuse_once(g: KernelGraph) -> tuple[KernelGraph, FusionDecision] | None:
    producers = g.producers()
    consumers = g.consumers()
    for node in g.nodes:
        if node.kind != "elementwise":
            continue
        for buf, t in node.inputs:
            if consumers.get(t) != [node.name]:
                continue
            pname = producers.get(t)
            if pname is None:
                continue
            prod = g.node(pname)
            if prod.kind not in FUSABLE_PRODUCERS:
                continue
            try:
                fused_prog, rename = fuse_epilogue(
                    prod.program, node.program, buf, return_map=True)
            except IRError:
                continue
            out_buf = prod.program.outputs[0]
            inputs = dict(prod.inputs)
            for b2, t2 in node.inputs:
                if t2 != t:
                    # consumer's extra operands keep their (possibly
                    # uniquified) buffer binding in the fused program
                    inputs[rename.get(b2, b2)] = t2
            fused = GraphNode(
                name=f"{prod.name}+{node.name}", program=fused_prog,
                inputs=tuple(sorted(inputs.items())),
                outputs=tuple((out_buf, t2) for _, t2 in node.outputs),
                kind="fused")
            # the fused node takes the *consumer's* slot: the producer's
            # only product was the wire, so no node in between needs it,
            # while the consumer's other operands may be produced late
            nodes = tuple(fused if n.name == node.name else n
                          for n in g.nodes if n.name != pname)
            tensors = {k: v for k, v in g.tensors.items() if k != t}
            g2 = KernelGraph(g.name, tensors, nodes, g.inputs, g.outputs)
            g2.validate()
            return g2, FusionDecision(node.name, pname, t,
                                      2 * g.tensors[t].nbytes)
    return None


def fuse_epilogues(g: KernelGraph) -> tuple[KernelGraph,
                                            list[FusionDecision]]:
    """Run epilogue fusion to fixpoint; returns (fused graph, decisions)."""
    decisions: list[FusionDecision] = []
    while True:
        step = _fuse_once(g)
        if step is None:
            return g, decisions
        g, d = step
        decisions.append(d)
