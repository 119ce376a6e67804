"""The whole-model graph IR — the tier above ``repro_torch.compile``'s kernels.

A ``KernelGraph`` is a DAG of ``GraphNode``s connected by named tensor edges
(``TensorSpec``).  Each node carries one kernel-level ISAMIR ``Program`` plus
a role-tagged wiring that binds the program's non-temp buffers to graph
tensors: ``inputs`` maps program buffers to the tensors they read,
``outputs`` to the tensors they produce.  The same invariants the kernel
tier enforces structurally (``Program.__post_init__``) hold one level up:

  * nodes are stored in a valid topological order — every tensor a node
    reads is a graph input or was produced by an earlier node;
  * every tensor has exactly one producer (a node or the graph boundary);
  * wired program buffers agree with their tensor's shape and dtype.

``validate()`` raises ``GraphError`` on violation; the tolerant
diagnostic-emitting twin lives in ``repro_torch.verify.graph`` (``gra.*`` rules).

Graphs round-trip through JSON (``to_dict``/``from_dict``) including their
node programs, and ``fingerprint()`` gives the content hash the tracer
determinism contract and the ``CompiledGraph`` artifact key on.
``interpret_graph`` is the graph-level oracle: it runs every node program
through ``core.ir.interpret`` (f64 internally) and casts each produced
tensor to its declared dtype at the node boundary — exactly the numeric
contract the card's execution (``execute.py``) and the torch reference
(``repro_torch.models.traceable``) follow.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

import numpy as np

from ..core.dtypes import dtype_bytes
from ..core.ir import (Access, Axis, Buffer, Program, Statement, interpret)

GRAPH_SCHEMA = 1

_NP_DTYPES = {"f32": np.float32, "f64": np.float64, "bf16": np.float32,
              "i32": np.int32}


class GraphError(ValueError):
    """Raised on malformed kernel graphs."""


# --------------------------------------------------------------------------- #
# Program (de)serialization — the graph tier is the first consumer that has
# to persist whole ISAMIR programs, not just their fingerprints.
# --------------------------------------------------------------------------- #


def program_to_dict(p: Program) -> dict:
    def acc(a: Access) -> dict:
        return {"buffer": a.buffer, "matrix": [list(r) for r in a.matrix],
                "offset": list(a.offset)}

    return {"name": p.name,
            "axes": [[a.name, a.size] for a in p.axes],
            "buffers": [[b.name, list(b.shape), b.dtype, int(b.temp)]
                        for b in p.buffers],
            "statements": [{"op": s.op, "fn": s.fn,
                            "lhs": acc(s.lhs), "rhs": acc(s.rhs)}
                           for s in p.statements],
            "outputs": list(p.outputs)}


def program_from_dict(d: dict) -> Program:
    def acc(a: dict) -> Access:
        return Access(a["buffer"], tuple(tuple(r) for r in a["matrix"]),
                      tuple(a["offset"]))

    return Program(
        d["name"],
        tuple(Axis(n, int(s)) for n, s in d["axes"]),
        tuple(Buffer(n, tuple(sh), dt, bool(t))
              for n, sh, dt, t in d["buffers"]),
        tuple(Statement(s["op"], acc(s["lhs"]), acc(s["rhs"]),
                        s.get("fn", "")) for s in d["statements"]),
        tuple(d.get("outputs", ())))


# --------------------------------------------------------------------------- #
# Nodes and edges
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class TensorSpec:
    """One graph edge: a named tensor with shape and dtype."""

    name: str
    shape: tuple[int, ...]
    dtype: str = "f32"

    @property
    def nbytes(self) -> int:
        n = dtype_bytes(self.dtype)
        for s in self.shape:
            n *= s
        return n

    def to_dict(self) -> dict:
        return {"name": self.name, "shape": list(self.shape),
                "dtype": self.dtype}

    @classmethod
    def from_dict(cls, d: dict) -> "TensorSpec":
        return cls(d["name"], tuple(d["shape"]), d.get("dtype", "f32"))


@dataclass(frozen=True)
class GraphNode:
    """One kernel: an ISAMIR program plus its tensor wiring.

    ``inputs``/``outputs`` are (program buffer, graph tensor) pairs; ``kind``
    tags the node for the fusion pass (``gemm`` | ``elementwise`` |
    ``fused``).
    """

    name: str
    program: Program
    inputs: tuple[tuple[str, str], ...]
    outputs: tuple[tuple[str, str], ...]
    kind: str = ""

    def consumed(self) -> tuple[str, ...]:
        return tuple(t for _, t in self.inputs)

    def produced(self) -> tuple[str, ...]:
        return tuple(t for _, t in self.outputs)

    def tensor_of(self, buf: str) -> str:
        for b, t in self.inputs + self.outputs:
            if b == buf:
                return t
        raise KeyError(buf)

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "program": program_to_dict(self.program),
                "inputs": [list(p) for p in self.inputs],
                "outputs": [list(p) for p in self.outputs]}

    @classmethod
    def from_dict(cls, d: dict) -> "GraphNode":
        return cls(d["name"], program_from_dict(d["program"]),
                   tuple((b, t) for b, t in d["inputs"]),
                   tuple((b, t) for b, t in d["outputs"]),
                   d.get("kind", ""))


@dataclass
class KernelGraph:
    """A DAG of kernel nodes over named tensors (see module docstring)."""

    name: str
    tensors: dict[str, TensorSpec]
    nodes: tuple[GraphNode, ...]
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]

    # -- invariants ----------------------------------------------------------
    def validate(self) -> None:
        known = set(self.tensors)
        for t in list(self.inputs) + list(self.outputs):
            if t not in known:
                raise GraphError(f"graph boundary names unknown tensor {t!r}")
        produced: set[str] = set(self.inputs)
        producers: dict[str, str] = {}
        names = set()
        for node in self.nodes:
            if node.name in names:
                raise GraphError(f"duplicate node name {node.name!r}")
            names.add(node.name)
            for buf, t in node.inputs + node.outputs:
                if t not in known:
                    raise GraphError(
                        f"{node.name}: wires unknown tensor {t!r}")
                try:
                    b = node.program.buffer(buf)
                except KeyError:
                    raise GraphError(
                        f"{node.name}: wires unknown buffer {buf!r}")
                spec = self.tensors[t]
                if tuple(b.shape) != tuple(spec.shape):
                    raise GraphError(
                        f"{node.name}: buffer {buf} shape {b.shape} != "
                        f"tensor {t} shape {spec.shape}")
                if b.dtype != spec.dtype:
                    raise GraphError(
                        f"{node.name}: buffer {buf} dtype {b.dtype} != "
                        f"tensor {t} dtype {spec.dtype}")
            for _, t in node.inputs:
                if t not in produced:
                    raise GraphError(
                        f"{node.name}: consumes {t!r} before it is produced "
                        f"(cycle or bad topological order)")
            for buf, t in node.outputs:
                if t in produced:
                    raise GraphError(
                        f"{node.name}: tensor {t!r} already has a producer "
                        f"({producers.get(t, 'graph input')})")
                if buf not in node.program.outputs:
                    raise GraphError(
                        f"{node.name}: wired output buffer {buf!r} is not a "
                        f"program output")
                produced.add(t)
                producers[t] = node.name
        for t in self.outputs:
            if t not in produced:
                raise GraphError(f"graph output {t!r} is never produced")

    # -- derived wiring maps -------------------------------------------------
    def producers(self) -> dict[str, str]:
        """tensor -> producing node name (graph inputs absent)."""
        return {t: n.name for n in self.nodes for t in n.produced()}

    def consumers(self) -> dict[str, list[str]]:
        """tensor -> consuming node names (graph outputs add ``<out>``)."""
        cons: dict[str, list[str]] = {t: [] for t in self.tensors}
        for n in self.nodes:
            for t in n.consumed():
                cons[t].append(n.name)
        for t in self.outputs:
            cons[t].append("<out>")
        return cons

    def node(self, name: str) -> GraphNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def intermediates(self) -> list[str]:
        """Tensors produced by a node and consumed inside the graph (the
        activations buffer placement decides over)."""
        boundary = set(self.inputs) | set(self.outputs)
        return [t for n in self.nodes for t in n.produced()
                if t not in boundary]

    # -- fingerprint / serialization ----------------------------------------
    def fingerprint(self) -> str:
        h = hashlib.sha256()
        h.update(json.dumps(self.to_dict(), sort_keys=True).encode())
        return h.hexdigest()[:16]

    def to_dict(self) -> dict:
        return {"schema": GRAPH_SCHEMA, "name": self.name,
                "tensors": [self.tensors[t].to_dict() for t in self.tensors],
                "nodes": [n.to_dict() for n in self.nodes],
                "inputs": list(self.inputs), "outputs": list(self.outputs)}

    @classmethod
    def from_dict(cls, d: dict) -> "KernelGraph":
        specs = [TensorSpec.from_dict(t) for t in d.get("tensors", [])]
        g = cls(name=d.get("name", ""),
                tensors={t.name: t for t in specs},
                nodes=tuple(GraphNode.from_dict(n)
                            for n in d.get("nodes", [])),
                inputs=tuple(d.get("inputs", ())),
                outputs=tuple(d.get("outputs", ())))
        g.validate()
        return g

    def summary(self) -> str:
        kinds: dict[str, int] = {}
        for n in self.nodes:
            kinds[n.kind or "?"] = kinds.get(n.kind or "?", 0) + 1
        ks = " ".join(f"{k}={v}" for k, v in sorted(kinds.items()))
        return (f"{self.name}: {len(self.nodes)} node(s) "
                f"({ks}), {len(self.tensors)} tensor(s), "
                f"fp={self.fingerprint()}")


@dataclass
class GraphBuilder:
    """Ergonomic front-end the tracer uses; ``build()`` validates."""

    name: str
    tensors: dict[str, TensorSpec] = field(default_factory=dict)
    nodes: list[GraphNode] = field(default_factory=list)
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)

    def tensor(self, name: str, shape, dtype: str = "f32",
               is_input: bool = False) -> str:
        if name in self.tensors:
            raise GraphError(f"duplicate tensor {name!r}")
        self.tensors[name] = TensorSpec(name, tuple(shape), dtype)
        if is_input:
            self.inputs.append(name)
        return name

    def node(self, name: str, program: Program, inputs: dict[str, str],
             outputs: dict[str, str], kind: str = "") -> GraphNode:
        n = GraphNode(name, program, tuple(sorted(inputs.items())),
                      tuple(sorted(outputs.items())), kind)
        self.nodes.append(n)
        return n

    def output(self, *names: str) -> None:
        self.outputs.extend(names)

    def build(self) -> KernelGraph:
        g = KernelGraph(self.name, dict(self.tensors), tuple(self.nodes),
                        tuple(self.inputs), tuple(self.outputs))
        g.validate()
        return g


# --------------------------------------------------------------------------- #
# The graph-level oracle
# --------------------------------------------------------------------------- #


def np_dtype(name: str):
    return _NP_DTYPES.get(name, np.float32)


def interpret_graph(g: KernelGraph, inputs: dict[str, np.ndarray],
                    return_all: bool = False) -> dict[str, np.ndarray]:
    """Run every node program through the ISAMIR interpreter, casting each
    produced tensor to its declared dtype at the node boundary."""
    env: dict[str, np.ndarray] = {}
    for t in g.inputs:
        if t not in inputs:
            raise GraphError(f"missing graph input {t!r}")
        arr = np.asarray(inputs[t], dtype=np_dtype(g.tensors[t].dtype))
        if arr.shape != g.tensors[t].shape:
            raise GraphError(
                f"input {t}: shape {arr.shape} != {g.tensors[t].shape}")
        env[t] = arr
    for node in g.nodes:
        ins = {buf: env[t] for buf, t in node.inputs}
        outs = interpret(node.program, ins)
        for buf, t in node.outputs:
            env[t] = outs[buf].astype(np_dtype(g.tensors[t].dtype))
    if return_all:
        return env
    return {t: env[t] for t in g.outputs}
