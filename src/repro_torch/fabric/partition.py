"""Shard an ISAMIR program across chips + the collectives each choice implies.

The contract is SPMD with *sharded outputs* (the same contract
a sharded model stack uses between layers: activations stay distributed, a
collective is inserted only where the math demands one):

  GEMM ``C[m,n] += A[m,k] * B[k,n]`` (A arrives m-sharded — the natural
  activation layout coming out of a previous data-parallel layer; B is the
  weight):

    * ``m``-sharding — chip *i* gets A's row block and full B, computes
      C's row block.  Purely data-parallel: **no collective**.
    * ``n``-sharding — column-parallel B; every chip needs *all* of A, so
      the m-sharded operand is **all-gathered** first.  C ends n-sharded.
    * ``k``-sharding — A column-/B row-sharded; every chip computes a
      full-size *partial* C which must be summed: a **reduce-scatter**
      leaves C m-sharded (``--replicate-out`` upgrades it to the full
      all-reduce).

  GRU (batch-sharding) — weights replicated, X/H row-sharded: pure data
  parallelism, no collective.

Bit-exact re-materialization: the sharded outputs must replay **bit-exact**
against the single-chip ISAMIR oracle.  Concatenation axes (m/n/batch) are
exact trivially; the k reduction is exact because the collective's numeric
semantics are defined as *ordered* accumulation (chip 0 first — the same
deterministic-reduction contract XLA offers), which ``replay_bitexact``
realizes by chaining the running C through the chips: a left fold over
chip partials extends the oracle's ascending-k left fold exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..compile import compile_selection, select_program
from ..core import instructions as I
from ..core import kernels_ir as K
from ..core.dtypes import dtype_bytes
from ..core.executor import Machine
from ..core.ir import Program, interpret, random_inputs
from ..core.isel import Selection
from ..core.scheduler import Schedule
from ..core.sysgraph import SystemGraph

GEMM_AXES = ("m", "n", "k")
GRU_AXES = ("batch",)


def split_extent(size: int, n: int) -> list[tuple[int, int]]:
    """(offset, length) per shard: balanced blocks — the first ``size % n``
    shards take one extra element, so every shard stays non-empty."""
    if n > size:
        raise ValueError(f"cannot split extent {size} into {n} shards")
    base, rem = divmod(size, n)
    out, off = [], 0
    for i in range(n):
        ln = base + (1 if i < rem else 0)
        out.append((off, ln))
        off += ln
    return out


@dataclass(frozen=True)
class CollectiveSpec:
    """One collective the partition choice implies.

    ``chunks`` are (offset, length) blocks of ``buffer`` along ``axis`` —
    chunk *i* is owned by (pre) / reduced onto (post) chip *i*.
    """

    kind: str                  # 'all_gather' | 'reduce_scatter' | 'all_reduce'
    buffer: str
    when: str                  # 'pre' (operand) | 'post' (output)
    axis: int
    chunks: tuple[tuple[int, int], ...]

    def chunk_nbytes(self, base: Program) -> list[int]:
        """Bytes of each chunk, from the global buffer's shape/dtype."""
        buf = base.buffer(self.buffer)
        per_unit = dtype_bytes(buf.dtype)
        for d, s in enumerate(buf.shape):
            if d != self.axis:
                per_unit *= s
        return [length * per_unit for _, length in self.chunks]


@dataclass(frozen=True)
class Shard:
    """One chip's subprogram + how to slice the global inputs for it."""

    chip: int
    program: Program
    slices: dict[str, tuple[slice, ...]] = field(default_factory=dict)


@dataclass
class PartitionedProgram:
    base: Program                       # the full single-chip program
    kernel: str                         # 'gemm' | 'gru'
    axis: str
    n_chips: int
    shards: list[Shard]
    collectives: list[CollectiveSpec]
    out_mode: str                       # 'concat' | 'chain_sum'
    out_axis: int = 0

    @property
    def output(self) -> str:
        return self.base.outputs[0]

    def shard_selection(self, shard: Shard) -> Selection:
        """Instruction selection for one shard, through the ``repro_torch.compile``
        Map/Select passes (memoized per shape)."""
        key = shard.program.signature()
        memo = getattr(self, "_sel_memo", None)
        if memo is None:
            memo = {}
            self._sel_memo = memo
        if key not in memo:
            if self.kernel == "gemm":
                memo[key] = select_program(
                    shard.program, [I.mxu_matmul()], allow_transforms=False)
            else:
                memo[key] = select_program(shard.program, I.tpu_isa())
        return memo[key]


def _full(nd: int) -> tuple[slice, ...]:
    return tuple(slice(None) for _ in range(nd))


def _slc(nd: int, dim: int, off: int, ln: int) -> tuple[slice, ...]:
    out = [slice(None)] * nd
    out[dim] = slice(off, off + ln)
    return tuple(out)


def partition_gemm(m: int, n: int, k: int, axis: str,
                   n_chips: int) -> PartitionedProgram:
    if axis not in GEMM_AXES:
        raise ValueError(f"GEMM partition axis must be one of {GEMM_AXES}")
    base = K.matmul(m, n, k)
    if n_chips == 1:
        return PartitionedProgram(base, "gemm", axis, 1,
                                  [Shard(0, base, {"A": _full(2),
                                                   "B": _full(2),
                                                   "C": _full(2)})],
                                  [], "concat", 0)
    size = {"m": m, "n": n, "k": k}[axis]
    blocks = split_extent(size, n_chips)
    shards: list[Shard] = []
    for i, (off, ln) in enumerate(blocks):
        if axis == "m":
            prog = K.matmul(ln, n, k)
            slices = {"A": _slc(2, 0, off, ln), "B": _full(2),
                      "C": _slc(2, 0, off, ln)}
        elif axis == "n":
            prog = K.matmul(m, ln, k)
            slices = {"A": _full(2), "B": _slc(2, 1, off, ln),
                      "C": _slc(2, 1, off, ln)}
        else:  # k
            prog = K.matmul(m, n, ln)
            slices = {"A": _slc(2, 1, off, ln), "B": _slc(2, 0, off, ln),
                      "C": _full(2)}
        shards.append(Shard(i, prog, slices))
    collectives: list[CollectiveSpec] = []
    if axis == "n":
        # A arrives m-sharded; every chip needs all of it.
        collectives.append(CollectiveSpec(
            "all_gather", "A", "pre", 0, tuple(split_extent(m, n_chips))))
    elif axis == "k":
        # Partial Cs must be summed; the output contract leaves C m-sharded.
        collectives.append(CollectiveSpec(
            "reduce_scatter", "C", "post", 0, tuple(split_extent(m, n_chips))))
    out_mode = "chain_sum" if axis == "k" else "concat"
    out_axis = {"m": 0, "n": 1, "k": 0}[axis]
    return PartitionedProgram(base, "gemm", axis, n_chips, shards,
                              collectives, out_mode, out_axis)


def partition_gru(batch: int, hidden: int, inp: int | None = None,
                  axis: str = "batch",
                  n_chips: int = 1) -> PartitionedProgram:
    if axis not in GRU_AXES:
        raise ValueError(f"GRU partition axis must be one of {GRU_AXES}")
    inp = hidden if inp is None else inp
    base = K.gru_cell(batch, hidden, inp)
    sharded_rank2 = {"X", "H"}           # batch-major activations
    blocks = split_extent(batch, n_chips)
    shards: list[Shard] = []
    for i, (off, ln) in enumerate(blocks):
        prog = K.gru_cell(ln, hidden, inp)
        slices: dict[str, tuple[slice, ...]] = {}
        for b in base.buffers:
            if b.temp:
                continue
            if b.name in sharded_rank2:
                slices[b.name] = _slc(2, 0, off, ln)
            elif b.name != base.outputs[0]:
                slices[b.name] = _full(b.rank)
        shards.append(Shard(i, prog, slices))
    # Weights are replicated and the hidden state stays batch-sharded:
    # pure data parallelism, no collective.
    return PartitionedProgram(base, "gru", axis, n_chips, shards, [],
                              "concat", 0)


def partition(kernel: str, shape: tuple[int, ...], axis: str,
              n_chips: int) -> PartitionedProgram:
    if kernel == "gemm":
        m, n, k = shape
        return partition_gemm(m, n, k, axis, n_chips)
    if kernel == "gru":
        batch, hidden = shape[0], shape[1]
        return partition_gru(batch, hidden, axis=axis, n_chips=n_chips)
    raise ValueError(f"unknown kernel {kernel!r} (gemm|gru)")


def partition_axes(kernel: str) -> tuple[str, ...]:
    return GEMM_AXES if kernel == "gemm" else GRU_AXES


# --------------------------------------------------------------------------- #
# Bit-exact re-materialization against the single-chip oracle
# --------------------------------------------------------------------------- #


def _execute_f64(sched: Schedule, selection: Selection,
                 inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """core.executor replay that keeps the f64 home arrays (the public
    ``execute`` casts to f32 per call; chained shards must fold in f64 and
    cast exactly once, like the oracle)."""
    machine = Machine(sched, inputs)
    for op in sched.ops:
        machine.run_op(op, selection)
    return {name: machine.home_data[name].copy()
            for name in sched.program.outputs}


def replay_sharded(pp: PartitionedProgram, graph: SystemGraph,
                   approach=None,
                   inputs: dict[str, np.ndarray] | None = None,
                   rng_seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Execute every shard through the scheduled-stream executor and
    re-materialize the global output.  Returns ``(sharded, oracle)`` as the
    output dtype — equality between them is the bit-exactness contract."""
    rng = np.random.default_rng(rng_seed)
    ins = dict(inputs) if inputs is not None else random_inputs(pp.base, rng)
    oracle = interpret(pp.base, ins)[pp.output]

    out_name = pp.output
    if pp.out_mode == "chain_sum":
        running = np.array(ins.get(out_name,
                                   np.zeros(pp.base.buffer(out_name).shape)),
                           dtype=np.float64)
        for shard in pp.shards:               # ordered accumulation: chip 0 first
            sins = {name: np.asarray(ins[name], np.float64)[sl]
                    for name, sl in shard.slices.items()
                    if name != out_name and name in ins}
            sins[out_name] = running
            sel = pp.shard_selection(shard)
            sched = compile_selection(sel, graph, approach).schedule
            running = _execute_f64(sched, sel, sins)[out_name]
        final = running
    else:
        parts = []
        for shard in pp.shards:
            sins = {name: np.asarray(ins[name], np.float64)[sl]
                    for name, sl in shard.slices.items() if name in ins}
            sel = pp.shard_selection(shard)
            sched = compile_selection(sel, graph, approach).schedule
            parts.append(_execute_f64(sched, sel, sins)[out_name])
        final = np.concatenate(parts, axis=pp.out_axis)
    return final.astype(oracle.dtype), oracle


def replay_bitexact(pp: PartitionedProgram, graph: SystemGraph,
                    approach=None, rng_seed: int = 0):
    """``ValidationReport``-shaped check of the re-materialization contract."""
    from ..search.evaluate import ValidationReport
    got, ref = replay_sharded(pp, graph, approach, rng_seed=rng_seed)
    exact = bool(np.array_equal(got, ref))
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    return ValidationReport(exact=exact,
                            max_abs_err=float(diff.max()) if diff.size else 0.0,
                            outputs=(pp.output,))
