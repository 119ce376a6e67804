"""Run a ``CompiledGraph`` on the card: the torch twin of the JAX package's
``CompiledGraph.execute``, which replays each node's schedule through the
NumPy executor.

Each node's compiled artifact (``CompiledGraph.node_kernels``) says how it
runs; only its ``lowering`` and the node's program are read, so a graph
read back by ``CompiledGraph.from_dict`` runs without ``ensure_kernels``:

  * a ``pallas_gpu_gemm`` node is one K1 launch (``kernels.gemm.gemm``) at
    the tile ``ops.launch_config`` maps the compiled block to.  Which
    operand is A and which is B, and whether one is stored transposed,
    comes from the program's access matrices (``gemm_operands``): the
    reduction axis is the one the output does not index.  A transposed
    operand (``matmul_nt``'s B, the attention scores' kᵀ) is copied once
    into the (K, N) contiguous layout K1 takes.  The tuning cache is not
    consulted: the artifact is what the graph tier compiled.
  * every other node (``stream``: the elementwise nodes and the fused
    GEMM + epilogue nodes, which the JAX package runs as executor-backed
    instruction streams, with no Pallas kernel) runs its program through
    ``interpret_program``: float64 on the node's device, one rounding at
    the node boundary, as the JAX replay does.

Every produced tensor is cast to its ``TensorSpec`` dtype at the node
boundary, as ``interpret_graph`` does.  Nothing falls back: a CUDA tensor
launches K1 or raises, and ``launch_config``'s errors propagate.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.ir import Access, IRError, Program
from ..kernels.cuda import resolve_device
from ..kernels.gemm import gemm
from ..kernels.ops import launch_config
from .ir import GraphError, np_dtype

#: the ISAMIR dtypes as torch dtypes — the same mapping as
#: ``core.ir._np_dtype`` (bf16 buffers hold f32, as in the NumPy oracle)
TORCH_DTYPES = {"f32": torch.float32, "f64": torch.float64,
                "bf16": torch.float32, "i32": torch.int32}

#: ``core.ir.UNARY_FNS`` in torch: the same functions, the same formulas
TORCH_UNARY_FNS = {
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "tanh": torch.tanh,
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "exp": torch.exp,
    "neg": torch.neg,
    "recip": lambda x: 1.0 / x,
    "sub_from_one": lambda x: 1.0 - x,
    "halve": lambda x: 0.5 * x,
    "id": lambda x: x,
}


def torch_dtype(name: str) -> torch.dtype:
    return TORCH_DTYPES.get(name, torch.float32)


# --------------------------------------------------------------------------- #
# Instruction streams: the ISAMIR interpreter in torch
# --------------------------------------------------------------------------- #


def _strides(buf: torch.Tensor, acc: Access,
             cols: list[int]) -> tuple[list[int], int]:
    """The affine access ``acc`` into ``buf`` as the strides and storage
    offset of a view over the statement's domain (the program axes
    ``cols``): its element at a domain point is the element the access
    reads or writes there; an axis the access does not use has stride 0."""
    strides = buf.stride()
    st = [sum(strides[r] * row[c] for r, row in enumerate(acc.matrix))
          for c in cols]
    if any(s < 0 for s in st):
        raise IRError(f"access {acc} has a negative stride")
    return st, buf.storage_offset() + sum(
        s * o for s, o in zip(strides, acc.offset))


def _injective(sizes, strides) -> bool:
    """Whether a strided view with no zero stride addresses each element
    once: sorted by stride, each stride must pass the span of the ones
    below it."""
    span = 0
    for st, n in sorted(zip(strides, sizes)):
        if n > 1 and st <= span:
            return False
        span += st * (n - 1)
    return True


def interpret_program(prog: Program, inputs: Mapping[str, object],
                      device=None) -> dict[str, torch.Tensor]:
    """Execute ``prog`` per ISAMIR analysis semantics, as
    ``core.ir.interpret`` does: in float64 on ``device`` (default: the
    card), each statement over its loop domain (the axes its accesses use)
    before the next begins; buffers not in ``inputs`` start at zero; only
    the program's outputs are cast, each to its buffer's dtype.

    Each access becomes a strided view of its buffer over the statement's
    domain.  Domain axes the written access does not use are reduced: by a
    sum for ``+=`` and ``-=``, a product for ``*=``, a max for ``max=`` —
    deterministic reductions, so two runs on the card give the same bits —
    and for ``:=`` and ``apply`` the last point wins, as in NumPy.  The sums
    take another order than NumPy's sequential ``add.at``, so results agree
    bit for bit where every sum is exact (integer data below 2^24 in f32,
    the graph tier's oracle inputs) and to rounding otherwise.  A statement
    whose written access addresses an element twice over the axes it uses
    raises ``IRError``."""
    dev = resolve_device(device)
    for a in prog.axes:
        if a.symbolic:
            raise IRError(f"cannot interpret program with symbolic axis {a.name}")
    bufs: dict[str, torch.Tensor] = {}
    for b in prog.buffers:
        bufs[b.name] = torch.zeros(b.shape, dtype=torch.float64, device=dev)
        if b.name in inputs:
            arr = torch.as_tensor(inputs[b.name])
            if tuple(arr.shape) != tuple(b.shape):
                raise IRError(f"input {b.name} shape {tuple(arr.shape)} != "
                              f"{b.shape}")
            bufs[b.name].copy_(arr)

    for s in prog.statements:
        cols = [ai for ai in range(len(prog.axes))
                if any(row[ai] for acc in (s.lhs, s.rhs) for row in acc.matrix)]
        sizes = tuple(prog.axes[c].size for c in cols)
        src, out = bufs[s.rhs.buffer], bufs[s.lhs.buffer]
        vals = src.as_strided(sizes, *_strides(src, s.rhs, cols))
        if src is out:
            vals = vals.clone()          # NumPy reads before it writes
        lst, loff = _strides(out, s.lhs, cols)
        kept = [d for d, st in enumerate(lst) if st]
        dropped = tuple(d for d, st in enumerate(lst) if not st)
        ksizes = tuple(sizes[d] for d in kept)
        kst = [lst[d] for d in kept]
        if not _injective(ksizes, kst):
            raise IRError(f"{prog.name}: statement {s.op} writes "
                          f"{s.lhs.buffer} more than once per element")
        target = out.as_strided(ksizes, kst, loff)
        if s.op in (":=", "apply"):
            for d in reversed(dropped):
                vals = vals.select(d, -1)
            target.copy_(TORCH_UNARY_FNS[s.fn](vals) if s.op == "apply"
                         else vals)
        elif s.op in ("+=", "-="):
            red = vals.sum(dim=dropped) if dropped else vals
            target.add_(red, alpha=1 if s.op == "+=" else -1)
        elif s.op == "*=":
            for d in reversed(dropped):
                vals = vals.prod(dim=d)
            target.mul_(vals)
        elif s.op == "max=":
            red = vals.amax(dim=dropped) if dropped else vals
            target.copy_(torch.maximum(target, red))
        else:  # pragma: no cover
            raise IRError(f"unhandled op {s.op}")
    return {name: bufs[name].to(torch_dtype(prog.buffer(name).dtype))
            for name in prog.outputs}


# --------------------------------------------------------------------------- #
# GEMM nodes: K1
# --------------------------------------------------------------------------- #


def _selected_axes(prog: Program, acc: Access) -> tuple[str, ...] | None:
    """The axis each dimension of ``acc`` reads, where every dimension reads
    exactly one axis with coefficient 1 and no offset; else ``None``."""
    names = []
    for row, off in zip(acc.matrix, acc.offset):
        nz = [ai for ai, c in enumerate(row) if c]
        if off or len(nz) != 1 or row[nz[0]] != 1:
            return None
        names.append(prog.axes[nz[0]].name)
    return tuple(names)


def gemm_operands(prog: Program):
    """Read a GEMM node's program: ``((A buffer, transposed), (B buffer,
    transposed), (m, n, k))`` for C (m, n) = A (m, k) @ B (k, n), where a
    transposed operand is stored (k, m) or (n, k).  The reduction axis is
    the one C does not index.  Raises ``GraphError`` on any program that is
    not ``t := A; t *= B; C += t`` over two operands."""
    def bad(why: str) -> GraphError:
        return GraphError(f"{prog.name}: not a two-operand GEMM program "
                          f"({why})")

    if [s.op for s in prog.statements] != [":=", "*=", "+="] \
            or len(prog.outputs) != 1:
        raise bad("statements " + str([s.op for s in prog.statements]))
    out = prog.outputs[0]
    load, mul, acc = prog.statements
    c_axes = _selected_axes(prog, acc.lhs)
    t_axes = _selected_axes(prog, acc.rhs)
    if acc.lhs.buffer != out or c_axes is None or len(c_axes) != 2 \
            or t_axes is None or not set(c_axes) < set(t_axes) \
            or len(set(t_axes)) != 3:
        raise bad("its output is not a 2-d sum over one axis")
    (ci, cj), (r,) = c_axes, tuple(set(t_axes) - set(c_axes))
    roles = {(ci, r): ("A", False), (r, ci): ("A", True),
             (r, cj): ("B", False), (cj, r): ("B", True)}
    found = {}
    for s in (load, mul):
        role = roles.get(_selected_axes(prog, s.rhs))
        if s.lhs.buffer != acc.rhs.buffer or role is None \
                or role[0] in found or prog.buffer(s.rhs.buffer).temp:
            raise bad(f"operand {s.rhs.buffer}")
        found[role[0]] = (s.rhs.buffer, role[1])
    size = {a.name: a.size for a in prog.axes}
    return found["A"], found["B"], (size[ci], size[cj], size[r])


def run_gemm_node(node, lowering: dict, ins: dict) -> dict:
    """One K1 launch for a ``pallas_gpu_gemm`` node at the compiled plan's
    tile; returns the program's output."""
    (a_buf, a_t), (b_buf, b_t), (m, n, k) = gemm_operands(node.program)
    if set(ins) != {a_buf, b_buf}:
        raise GraphError(f"{node.name}: a GEMM node is wired {sorted(ins)}, "
                         f"not its operands {sorted((a_buf, b_buf))}")
    a, b = ins[a_buf], ins[b_buf]
    a = a.t().contiguous() if a_t else a
    b = b.t().contiguous() if b_t else b
    tile = launch_config(lowering, torch.float32, (m, n, k)).tile
    return {node.program.outputs[0]: gemm(a, b, tile=tile)}


# --------------------------------------------------------------------------- #
# The graph
# --------------------------------------------------------------------------- #


def execute_graph(cg, inputs: Mapping[str, object], device=None,
                  return_all: bool = False) -> dict[str, torch.Tensor]:
    """Run every node of the ``CompiledGraph`` ``cg`` in graph order on
    ``device`` (default: the card, raising without one; ``"cpu"`` runs the
    same dispatch on the kernels' plain versions).  ``inputs`` may be NumPy
    arrays or tensors; the result is the graph's outputs (with
    ``return_all``, every tensor, inputs included) as tensors on the
    device, each in its ``TensorSpec`` dtype."""
    g = cg.graph
    if g is None:
        raise GraphError("CompiledGraph has no graph attached; "
                         "rebuild via from_dict/compile_graph")
    dev = resolve_device(device)
    env: dict[str, torch.Tensor] = {}
    for t in g.inputs:
        if t not in inputs:
            raise GraphError(f"missing graph input {t!r}")
        spec = g.tensors[t]
        x = inputs[t]
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x, dtype=np_dtype(spec.dtype)))
        x = x.to(dev, torch_dtype(spec.dtype)).contiguous()
        if tuple(x.shape) != tuple(spec.shape):
            raise GraphError(f"input {t}: shape {tuple(x.shape)} != "
                             f"{spec.shape}")
        env[t] = x
    for node in g.nodes:
        lowering = cg.kernels[cg.node_kernels[node.name]].lowering
        ins = {buf: env[t] for buf, t in node.inputs}
        if lowering.get("kind") == "stream":
            outs = interpret_program(node.program, ins, dev)
        else:
            outs = run_gemm_node(node, lowering, ins)
        for buf, t in node.outputs:
            env[t] = outs[buf].to(torch_dtype(g.tensors[t].dtype))
    if return_all:
        return env
    return {t: env[t] for t in g.outputs}
