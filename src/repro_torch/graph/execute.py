"""Run a ``CompiledGraph`` on the card: the torch twin of the JAX package's
``CompiledGraph.execute``, which replays each node's schedule through the
NumPy executor.

Each node's compiled artifact (``CompiledGraph.node_kernels``) says how it
runs; only its ``lowering``, its plan (``instrs``) and the node's program
are read, so a graph read back by ``CompiledGraph.from_dict`` runs without
``ensure_kernels``.  What each node does is read once per graph
(``gemm_step``) and kept on it:

  * a ``pallas_gpu_gemm`` node is one K1 launch (``kernels.gemm.gemm``) at
    the tile ``ops.launch_config`` maps the compiled block to.  Which
    operand is A and which is B, and whether one is stored transposed,
    comes from the program's access matrices (``gemm_operands``): the
    reduction axis is the one the output does not index.  A transposed
    operand (``matmul_nt``'s B, the attention scores' kᵀ) is copied once
    into the (K, N) contiguous layout K1 takes.  The tuning cache is not
    consulted: the artifact is what the graph tier compiled.
  * a ``stream`` node whose program starts with that GEMM triple (the fused
    GEMM + epilogue nodes, and the tracers' biased projections, which the
    JAX package runs as executor-backed instruction streams) runs the
    triple as one K1 launch at its plan's matmul tile; where the next
    statement is ``C += bias[j]``, optionally followed by one of K2's
    activations, the triple and those are one K2 launch
    (``kernels.gemm.gemm_bias_act``) instead.  The statements left run
    through ``interpret_program`` on the (m, n) result and the node's
    other operands: the (m, n, k) product is never allocated.
  * every other node (``stream``: elementwise and reduction nodes) runs its
    program through ``interpret_program``: float64 on the node's device,
    one rounding at the node boundary, as the JAX replay does.

A GEMM's sum is rounded to f32 before an epilogue reads it, where the
interpreter keeps float64: the results agree bit for bit where every value
stays an integer below 2^24 (the tracers' ternary oracle inputs), and to
rounding otherwise.  Every produced tensor is cast to its ``TensorSpec``
dtype at the node boundary, as ``interpret_graph`` does.  Nothing falls
back: a CUDA tensor launches K1 or K2 or raises, and ``launch_config``'s
errors propagate.

On a card a ``CompiledGraph``'s node loop is one fixed chain of launches
on PyTorch's current stream, so from its second call it is one CUDA graph
(``Replay``, kept per device on ``CompiledGraph.replays``): the first call
runs eagerly and warms the kernels and the allocator; the second captures
the node loop under ``torch.cuda.graph`` and replays it once; every later
call replays.  The same kernels run at the same tiles on the same values,
so a replay gives an eager run's bits.  The capture binds one static
tensor per graph input; a replay copies each input into it, unless the
input is the tensor object copied last time and its ``_version`` has not
moved (a change PyTorch does not count, through ``.data`` or a pointer,
is not seen), and returns clones of the static outputs, which the next
replay overwrites.  ``device="cpu"`` and ``return_all`` always run
eagerly.  A capture that fails raises.

A request is the span ``graph.execute``; below it ``graph.gemm`` (a K1 or
K2 node's dispatch, its operand transposes included), ``graph.epilogue``
(the statements after the launch) and ``graph.stream`` (an interpreted
node); on a card from the second call, ``graph.capture`` (the capture,
with the node loop's spans below it) or ``graph.replay`` (copies in, the
replay, the clones out).  The counters ``graph.nodes``,
``graph.gemm_nodes`` (K1 or K2), ``graph.k2_nodes`` (K2 among them) and
``graph.stream_nodes`` count the nodes run; ``graph.capture`` and
``graph.replay`` count captures and replays.  A replay advances every
counter that moved during its capture by what it counted there, since the
card runs those nodes and launches again.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np
import torch

from ..core.ir import Access, IRError, Program
from ..kernels.cuda import resolve_device
from ..kernels.gemm import ACTS, gemm, gemm_bias_act
from ..kernels.ops import launch_config
from ..telemetry import count, counters, span
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
# GEMM nodes: K1 and K2
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


def _gemm_head(prog: Program):
    """Read the GEMM triple ``t := A; t *= B; C += t`` a program starts
    with: ``((A, transposed), (B, transposed), (m, n, k), t, (ci, cj))``,
    ``ci``/``cj`` the axes C is indexed by.  Raises ``GraphError`` where
    the program does not start with one."""
    def bad(why: str) -> GraphError:
        return GraphError(f"{prog.name}: not a two-operand GEMM program "
                          f"({why})")

    if [s.op for s in prog.statements[:3]] != [":=", "*=", "+="] \
            or len(prog.outputs) != 1:
        raise bad("statements " + str([s.op for s in prog.statements]))
    out = prog.outputs[0]
    load, mul, acc = prog.statements[:3]
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
    return (found["A"], found["B"], (size[ci], size[cj], size[r]),
            acc.rhs.buffer, (ci, cj))


def gemm_operands(prog: Program):
    """Read a GEMM node's program: ``((A buffer, transposed), (B buffer,
    transposed), (m, n, k))`` for C (m, n) = A (m, k) @ B (k, n), where a
    transposed operand is stored (k, m) or (n, k).  The reduction axis is
    the one C does not index.  Raises ``GraphError`` on any program that is
    not ``t := A; t *= B; C += t`` over two operands."""
    head = _gemm_head(prog)
    if len(prog.statements) != 3:
        raise GraphError(f"{prog.name}: not a two-operand GEMM program "
                         f"(statements "
                         f"{[s.op for s in prog.statements]})")
    return head[:3]


@dataclass(frozen=True)
class GemmStep:
    """How a node whose program starts with the GEMM triple runs: one K1
    launch (``bias`` None) or one K2 launch (``gemm_bias_act`` with the
    bias buffer and ``act``) at ``tile`` (None: K1's own choice), then the
    program's remaining statements (``epilogue``, None when there are
    none) through ``interpret_program`` on the (m, n) result."""

    a: tuple[str, bool]
    b: tuple[str, bool]
    shape: tuple[int, int, int]
    out: str
    tile: tuple[int, int, int] | None
    bias: str | None = None
    act: str = ""
    epilogue: Program | None = None


def _plan_tile(kernel, prog: Program, shape) -> tuple[int, int, int] | None:
    """K1's tile for a stream node's GEMM: the block of the compiled plan's
    matmul instruction (``mxu.matmul`` or ``fused.matmul_bias``), mapped as
    ``launch_config`` maps a ``pallas_gpu_gemm`` block; None where the plan
    has no such instruction."""
    for p in kernel.instrs:
        if not p.needle.startswith(("mxu.matmul", "fused.matmul_bias")):
            continue
        tiles, axes = dict(p.tile), dict(p.axis_map)
        if not set("ijk") <= set(tiles) & set(axes):
            return None
        block = tuple(min(tiles[r], prog.axis(axes[r]).size) for r in "ijk")
        return launch_config({"kind": "pallas_gpu_gemm", "block": block},
                             torch.float32, shape).tile
    return None


def gemm_step(node, kernel) -> GemmStep | None:
    """The node's ``GemmStep``, or None where it runs through
    ``interpret_program`` (a ``stream`` node that does not start with the
    GEMM triple, or whose rest reads the triple's product or C's old
    value).  A ``pallas_gpu_gemm`` node is one K1 launch at its lowering's
    tile.  A ``stream`` node that starts with the triple is one K1 launch
    at its plan's tile, or one K2 launch where the next statement is
    ``C += bias[j]`` (and, if the one after is a K2 activation of C in
    place, that too); the statements left are its epilogue."""
    prog, lowering = node.program, kernel.lowering
    wired = {buf for buf, _ in node.inputs}
    if lowering.get("kind") != "stream":
        a, b, shape = gemm_operands(prog)
        if wired != {a[0], b[0]}:
            raise GraphError(f"{node.name}: a GEMM node is wired "
                             f"{sorted(wired)}, not its operands "
                             f"{sorted((a[0], b[0]))}")
        tile = launch_config(lowering, torch.float32, shape).tile
        return GemmStep(a, b, shape, prog.outputs[0], tile)
    try:
        a, b, shape, tmp, (ci, cj) = _gemm_head(prog)
    except GraphError:
        return None
    out = prog.outputs[0]
    rest = list(prog.statements[3:])
    if out in wired or not {a[0], b[0]} <= wired or any(
            tmp in (s.lhs.buffer, s.rhs.buffer) for s in rest):
        return None

    def on_c(acc) -> bool:
        return acc.buffer == out and _selected_axes(prog, acc) == (ci, cj)

    bias, act = None, ""
    if rest and rest[0].op == "+=" and on_c(rest[0].lhs) \
            and rest[0].rhs.buffer in wired \
            and _selected_axes(prog, rest[0].rhs) == (cj,):
        bias = rest.pop(0).rhs.buffer
        if rest and rest[0].op == "apply" and rest[0].fn in ACTS \
                and on_c(rest[0].lhs) and on_c(rest[0].rhs):
            act = rest.pop(0).fn
    epilogue = None
    if rest:
        used = {out} | {acc.buffer for s in rest for acc in (s.lhs, s.rhs)}
        epilogue = Program(f"{prog.name}~epilogue", prog.axes,
                           tuple(bf for bf in prog.buffers
                                 if bf.name in used),
                           tuple(rest), (out,))
    return GemmStep(a, b, shape, out, _plan_tile(kernel, prog, shape),
                    bias, act, epilogue)


def run_gemm_step(step: GemmStep, ins: dict) -> dict:
    """One K1 or K2 launch, then the epilogue; returns the program's
    output."""
    count("graph.gemm_nodes")
    with span("graph.gemm"):
        (a_buf, a_t), (b_buf, b_t) = step.a, step.b
        a, b = ins[a_buf], ins[b_buf]
        a = a.t().contiguous() if a_t else a
        b = b.t().contiguous() if b_t else b
        if step.bias is None:
            c = gemm(a, b, tile=step.tile)
        else:
            count("graph.k2_nodes")
            c = gemm_bias_act(a, b, ins[step.bias], step.act, tile=step.tile)
    if step.epilogue is None:
        return {step.out: c}
    with span("graph.epilogue"):
        return interpret_program(step.epilogue, {**ins, step.out: c},
                                 c.device)


# --------------------------------------------------------------------------- #
# The graph
# --------------------------------------------------------------------------- #


def node_steps(cg) -> dict:
    """Each node's ``gemm_step`` (None: interpreted), read from its program
    and artifact once per ``CompiledGraph`` and kept on it."""
    if cg.steps is None:
        cg.steps = {n.name: gemm_step(n, cg.kernels[cg.node_kernels[n.name]])
                    for n in cg.graph.nodes}
    return cg.steps


@dataclass(eq=False)
class Replay:
    """A ``CompiledGraph``'s CUDA graph on one device: eager ``runs`` so
    far, then the captured ``graph``, its static inputs and outputs, what
    each static input last copied (a weak reference to the caller's tensor
    and its ``_version``), and the counters one run advances."""

    runs: int = 0
    graph: object = None                   # torch.cuda.CUDAGraph
    inputs: dict = field(default_factory=dict)
    copied: dict = field(default_factory=dict)
    outputs: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)


def _input(g, inputs: Mapping[str, object], t: str):
    """Graph input ``t`` as a tensor (a NumPy array in its ``TensorSpec``
    dtype, as it was given otherwise)."""
    if t not in inputs:
        raise GraphError(f"missing graph input {t!r}")
    x = inputs[t]
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x, dtype=np_dtype(g.tensors[t].dtype)))
    return x


def _check_shape(g, t: str, x: torch.Tensor) -> None:
    spec = g.tensors[t]
    if tuple(x.shape) != tuple(spec.shape):
        raise GraphError(f"input {t}: shape {tuple(x.shape)} != "
                         f"{spec.shape}")


def _bind(g, inputs: Mapping[str, object], dev) -> dict[str, torch.Tensor]:
    """Each graph input on ``dev``, contiguous, in its ``TensorSpec``
    dtype (the caller's tensor itself where it already is)."""
    env = {}
    for t in g.inputs:
        x = _input(g, inputs, t).to(dev, torch_dtype(g.tensors[t].dtype))
        x = x.contiguous()
        _check_shape(g, t, x)
        env[t] = x
    return env


def _run_nodes(g, steps: dict, env: dict, dev) -> None:
    """Every node in graph order, each output cast to its ``TensorSpec``
    dtype into ``env``."""
    for node in g.nodes:
        count("graph.nodes")
        ins = {buf: env[t] for buf, t in node.inputs}
        step = steps[node.name]
        if step is None:
            count("graph.stream_nodes")
            with span("graph.stream"):
                outs = interpret_program(node.program, ins, dev)
        else:
            outs = run_gemm_step(step, ins)
        for buf, t in node.outputs:
            env[t] = outs[buf].to(torch_dtype(g.tensors[t].dtype))


def _version(x) -> int | None:
    """``x._version``; None for what has none (an array, an inference
    tensor), which is copied every time."""
    if not isinstance(x, torch.Tensor) or x.is_inference():
        return None
    return x._version


def _copy_in(rep: Replay, g, inputs: Mapping[str, object]) -> None:
    """Copy each graph input into its static tensor, unless it is the
    tensor copied there last, unchanged since."""
    for t in g.inputs:
        given = inputs.get(t)
        version = _version(given)
        last = rep.copied.get(t)
        if version is not None and last is not None \
                and last[0]() is given and last[1] == version:
            continue
        x = _input(g, inputs, t)
        _check_shape(g, t, x)
        rep.inputs[t].copy_(x)
        rep.copied[t] = (None if version is None else weakref.ref(given),
                         version)


def _capture(rep: Replay, cg, inputs: Mapping[str, object], dev) -> None:
    """Bind the static inputs and capture the node loop into
    ``rep.graph``; a capture that fails raises, and the next call tries
    again."""
    g = cg.graph
    rep.inputs = {t: torch.empty(g.tensors[t].shape,
                                 dtype=torch_dtype(g.tensors[t].dtype),
                                 device=dev) for t in g.inputs}
    rep.copied = {}
    _copy_in(rep, g, inputs)
    before = counters()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        env = dict(rep.inputs)
        _run_nodes(g, node_steps(cg), env, dev)
    after = counters()
    rep.counts = {n: v - before.get(n, 0) for n, v in after.items()
                  if v != before.get(n, 0)}
    rep.outputs = {t: env[t] for t in g.outputs}
    rep.graph = graph
    count("graph.capture")


def _advance(counts: dict) -> None:
    """Advance the counters by what one run counted."""
    for name, n in counts.items():
        count(name, n)


def _replayed(rep: Replay) -> dict[str, torch.Tensor]:
    """Replay the graph; clones of its outputs, which the next replay
    overwrites."""
    rep.graph.replay()
    return {t: v.clone() for t, v in rep.outputs.items()}


def _replay(rep: Replay, cg, inputs: Mapping[str, object],
            dev) -> dict[str, torch.Tensor]:
    """A call after the first on ``dev``: the capture and the replay that
    gives its result, or the inputs copied in and a replay."""
    if rep.graph is None:
        with span("graph.capture"):
            _capture(rep, cg, inputs, dev)
            return _replayed(rep)
    with span("graph.replay"):
        _copy_in(rep, cg.graph, inputs)
        out = _replayed(rep)
    count("graph.replay")
    _advance(rep.counts)
    return out


def execute_graph(cg, inputs: Mapping[str, object], device=None,
                  return_all: bool = False) -> dict[str, torch.Tensor]:
    """Run every node of the ``CompiledGraph`` ``cg`` in graph order on
    ``device`` (default: the card, raising without one; ``"cpu"`` runs the
    same dispatch on the kernels' plain versions).  ``inputs`` may be NumPy
    arrays or tensors; the result is the graph's outputs (with
    ``return_all``, every tensor, inputs included) as tensors on the
    device, each in its ``TensorSpec`` dtype.  On a card, without
    ``return_all``, the first call on a device runs eagerly, the second
    captures the node loop as one CUDA graph, and every later call
    replays it (see the module's docstring)."""
    g = cg.graph
    if g is None:
        raise GraphError("CompiledGraph has no graph attached; "
                         "rebuild via from_dict/compile_graph")
    dev = resolve_device(device)
    steps = node_steps(cg)
    replays = dev.type == "cuda" and not return_all
    if replays:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if dev.index is None else dev.index)
        rep = cg.replays.setdefault(dev, Replay())
        if rep.runs:
            with torch.cuda.device(dev), span("graph.execute"):
                return _replay(rep, cg, inputs, dev)
    with span("graph.execute"):
        env = _bind(g, inputs, dev)
        _run_nodes(g, steps, env, dev)
    if replays:
        rep.runs += 1
    if return_all:
        return env
    return {t: env[t] for t in g.outputs}
