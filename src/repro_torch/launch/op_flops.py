"""FLOPs, bytes and collective traffic of one traced step, from its aten
ops: the port's counterpart of the JAX package's ``launch/hlo_flops.py``,
which reads them from the optimized HLO of the per-device program.

``OpCounter`` is a ``TorchDispatchMode`` that counts what one rank runs.
It declines every op on a DTensor, so DTensor dispatches it and the mode
sees the local op on this rank's shards that DTensor issues instead, and
the ``_c10d_functional`` collectives of its redistributions; the ops that
DTensor runs on global shapes to propagate shapes are not counted.  So, as
in JAX's SPMD module, replicated compute is counted once a rank, and the
job's totals are the counts times the number of ranks (``dryrun.analyse``).
A ``FlopCounterMode`` entered above DTensor counts each product once,
globally, which is another quantity.

  * FLOPs: products only, 2 x |out| x contraction (``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``mv``, ``dot``, ``convolution``), as
    ``hlo_flops`` counts ``dot``.
  * bytes: each op's operands plus its results, views and metadata
    excluded.  Eager torch runs every op as a kernel, so nothing fuses.
  * collective bytes: the operand bytes of each all-gather, all-reduce,
    reduce-scatter and all-to-all, by kind and count, as
    ``hlo_analysis.parse_collectives`` sums HLO operands.
  * live bytes: the bytes of the tensors the counted ops create, from
    creation until the tensor (with its views) is freed, and their peak.

Eager torch has no ``while`` loop to multiply, so there is no trip count.
"""
from __future__ import annotations

import contextlib
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .hlo_analysis import CollectiveStats

aten = torch.ops.aten

#: collective op name (``_c10d_functional`` and its autograd twin) -> kind
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")

#: ops that move no data: waits, metadata, aliases
_FREE = {"wait_tensor", "device", "detach", "lift_fresh", "alias",
         "_unsafe_view", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "dim", "is_same_size", "_local_scalar_dense"}


def _numel(t: torch.Tensor) -> int:
    return math.prod(t.shape)


def _bytes(tree) -> int:
    return sum(_numel(t) * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def dot_flops(func, args, out) -> int:
    """2 x |out| x contraction of one product op, else 0."""
    packet = func.overloadpacket
    if packet in (aten.mm, aten.bmm, aten.mv, aten.dot):
        return 2 * _numel(out) * args[0].shape[-1]
    if packet in (aten.addmm, aten.baddbmm):
        return 2 * _numel(out) * args[1].shape[-1]
    if packet is aten.convolution:
        w, groups = args[1], args[8]
        return 2 * _numel(out) * (w.shape[1] * math.prod(w.shape[2:]))
    return 0


class OpCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes and collectives while it is active
    (``flops``, ``bytes_accessed``, ``collectives``: a
    ``hlo_analysis.CollectiveStats``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = CollectiveStats()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._paused = 0
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(self._pause_in_shape_propagation())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    @contextlib.contextmanager
    def _pause_in_shape_propagation(self):
        """DTensor runs each op once on global shapes (fake tensors) to
        learn its output's shape; those ops are not this rank's work."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator

        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def propagate(prop, op_schema):
            counter._paused += 1
            try:
                return orig(prop, op_schema)
            finally:
                counter._paused -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        try:
            yield
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = orig

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:
            return out
        ns = func.namespace
        name = func.overloadpacket.__name__
        if not (func.is_view or name in _FREE):
            self._track(out, args)
        if ns in _NAMESPACES:
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                nb = _bytes(args[0])
                stats = self.collectives
                stats.bytes_by_kind[kind] = \
                    stats.bytes_by_kind.get(kind, 0) + nb
                stats.count_by_kind[kind] = \
                    stats.count_by_kind.get(kind, 0) + 1
            return out
        if name in _FREE or func.is_view:
            return out
        self.flops += dot_flops(func, args, out)
        self.bytes_accessed += _bytes((args, kwargs)) + _bytes(out)
        return out

    def _track(self, out, args) -> None:
        """Count each new tensor of ``out`` live until it is freed (an
        in-place op's output is its input, and holds no new bytes)."""
        seen = {id(a) for a in tree_leaves(args)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or t._base is not None \
                    or id(t) in seen:
                continue
            nb = _numel(t) * t.element_size()
            self.live_bytes += nb
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(t, self._free, nb)

    def _free(self, nb: int) -> None:
        self.live_bytes -= nb
