"""Multi-pod dry run of the port: the JAX package's ``launch/dryrun.py``
on DTensors.

For every (architecture x input shape x mesh) cell this places the real
train, prefill or decode step's parameters, optimizer state, batch and
cache by the production rules on a ``DeviceMesh`` of 256 or 512 ranks of a
``fake`` process group, traces one step under ``FakeTensorMode`` (no value
is computed and nothing is allocated), and records what one rank runs:

  * FLOPs, bytes and collective traffic from the aten ops of the trace
    (``launch.op_flops``: one rank's ops on its local shards, so the job's
    totals are the counts times the ranks, as JAX's per-device SPMD module
    times ``chips``);
  * roofline terms on ``--target`` (``launch.hlo_analysis``; default
    ``gpu_sm``, the H100 data-sheet row);
  * ``model_flops`` and its ratio to the traced FLOPs, as JAX computes them.

The record keeps JAX's keys where the port has the quantity.
``compile_s`` holds the trace's seconds.  ``memory`` holds one rank's
``argument_bytes`` (parameters, optimizer state, batch and cache pieces),
within it ``param_bytes`` and ``opt_state_bytes``, and ``peak_bytes``: the
arguments plus the peak of the bytes that the step's ops hold live
(``OpCounter.peak_bytes``).  XLA's
``xla_cost_analysis``, ``while_trip_counts`` and ``generated_code_bytes``
have no counterpart here and are left out.  File names, exit codes and the
``[ok]``/``[skip]``/``[error]`` lines are JAX's.

One process has one world: a fake group of 512 ranks serves both meshes,
the single one on its first 256 (``launch.mesh.make_production_mesh``).

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import ARCHS, cell_applicable, get_config, input_specs
from ..dist.ctx import activation_sharding_ctx
from ..dist.sharding import (batch_shardings, cache_shardings,
                             layer_shardings, make_activation_rules,
                             param_shardings, place_tree, shard_shape)
from ..models.convert import jax_items
from ..models.config import SHAPES
from .hlo_analysis import TARGET_ROOFLINES, roofline_terms
from .mesh import make_production_mesh
from .op_flops import OpCounter
from .steps import (eval_shape_cache, eval_shape_params, make_prefill_step,
                    make_serve_step, make_train_step)


def local_bytes(tree) -> int:
    """Bytes of this rank's pieces of the tensors in ``tree`` (nested
    mappings, sequences, tensors)."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return math.prod(t.shape) * t.element_size()
    return 0


def rule_param_bytes(cfg, mesh, itemsize: int | None = None) -> int:
    """One rank's bytes of the parameters of ``cfg`` as the rules cut them
    on ``mesh`` (an abstract mesh will do): the product of each JAX leaf's
    shard shape, times ``itemsize`` (default: the leaf's), summed."""
    _, params = eval_shape_params(cfg)
    shardings = param_shardings(params, mesh, cfg)
    total = 0
    for path, leaf in jax_items(params):
        sh = shardings
        for p in path:
            sh = sh[p]
        first = next(iter(leaf.members.values())) \
            if hasattr(leaf, "members") else leaf
        total += math.prod(shard_shape(leaf.shape, sh.spec, mesh)) * (
            itemsize or first.element_size())
    return total


def _redistribute(tree, shardings, prefix=""):
    """``tree``'s DTensors moved to their ``shardings`` (dotted name ->
    NamedSharding), as JAX's ``out_shardings`` place a step's outputs."""
    out = {}
    for k, t in tree.items():
        name = f"{prefix}{k}"
        out[k] = _redistribute(t, shardings, name + ".") \
            if isinstance(t, dict) else t.redistribute(
                t.device_mesh, shardings[name].placements)
    return out


def _replicated(t):
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


@contextlib.contextmanager
def _strided_offsets_outside_fake_mode():
    """DTensor computes a strided shard's offsets (two mesh dimensions
    cutting one merged dimension, as (batch, heads) in attention's
    products) with tensor ops on index tensors; under ``FakeTensorMode``
    those are fake and their ``tolist()`` fails, so the dry run runs that
    bookkeeping with fake mode off.  It reads no tensor of the step."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    orig = getattr(_StridedShard, "local_shard_size_and_offset", None)
    if orig is None:                # a torch that computes them otherwise
        yield
        return

    def offsets(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = offsets
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict | None = None):
    """Place and trace one cell; returns (counter, memory, meta): the
    ``OpCounter`` of the step, one rank's memory, and the cell."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, fake_group=True)
    rules = make_activation_rules(mesh, cfg)
    counter = OpCounter()
    memory: dict = {}

    with FakeTensorMode(), _strided_offsets_outside_fake_mode():
        specs = input_specs(cfg, shape)
        batch = place_tree(specs, layer_shardings(
            specs, batch_shardings(specs, mesh)))
        if shape.kind == "train":
            model, opt_state, train_step = make_train_step(
                cfg, device="meta", mesh=mesh)
            memory["opt_state_bytes"] = local_bytes(tuple(opt_state))
            args = (batch, opt_state)

            def run():
                return train_step(batch)
        elif shape.kind == "prefill":
            model, prefill_step = make_prefill_step(
                cfg, max_len=shape.seq_len, device="meta", mesh=mesh)
            cache = eval_shape_cache(cfg, shape.global_batch,
                                     shape.seq_len)
            cache_sh = layer_shardings(cache, cache_shardings(cache, mesh,
                                                              cfg))
            args = (batch,)

            def run():
                cache, logits = prefill_step(batch)
                return _redistribute(cache, cache_sh), _replicated(logits)
        else:
            model, serve_step = make_serve_step(cfg, device="meta",
                                                mesh=mesh)
            cache = eval_shape_cache(cfg, shape.global_batch, shape.seq_len,
                                     mesh)
            cache_sh = layer_shardings(cache, cache_shardings(cache, mesh,
                                                              cfg))
            args = (batch, cache)

            def run():
                logits, new = serve_step(cache, batch["tokens"],
                                         shape.seq_len - 1)
                return _replicated(logits), _redistribute(new, cache_sh)

        params = dict(model.named_parameters())
        memory["param_bytes"] = local_bytes(params)
        memory["argument_bytes"] = memory["param_bytes"] + local_bytes(args)
        with activation_sharding_ctx(rules), implicit_replication(), \
                counter:
            run()
        memory["peak_bytes"] = memory["argument_bytes"] + counter.peak_bytes
    return counter, memory, {"chips": mesh.size, "cfg": cfg,
                             "shape": shape}


def analyse(counter, memory, meta, elapsed: float,
            target: str = "gpu_sm") -> dict:
    chips = meta["chips"]
    cfg, shape = meta["cfg"], meta["shape"]
    out: dict = {"arch": cfg.name, "shape": shape.name, "chips": chips,
                 "kind": shape.kind, "target": target,
                 "compile_s": round(elapsed, 2)}
    out["memory"] = dict(memory)
    flops = counter.flops
    nbytes = counter.bytes_accessed
    stats = counter.collectives
    out["hlo_flops"] = flops
    out["hlo_bytes"] = nbytes
    out["collectives"] = stats.as_dict()
    # the counts are one rank's; scale to the job.
    out["roofline"] = roofline_terms(flops * chips, nbytes * chips,
                                     stats.total_bytes * chips, chips,
                                     target=target)
    # Model FLOPs: 6 * N_active * D(tokens) for training; decode counts 1 tok
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        out["model_flops"] = 6 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        out["model_flops"] = 2 * n_active * tokens
    else:
        out["model_flops"] = 2 * n_active * shape.global_batch
    total = flops * chips
    out["model_flops_ratio"] = (out["model_flops"] / total
                                if total else None)
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             overrides: dict | None = None,
             target: str = "gpu_sm") -> dict:
    multi = mesh_kind == "multi"
    t0 = time.time()
    record: dict
    if not cell_applicable(arch, shape_name):
        record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "status": "skipped",
                  "reason": "full-attention arch: long_500k inapplicable "
                            "(DESIGN.md §Arch-applicability)"}
    else:
        try:
            counter, memory, meta = lower_cell(arch, shape_name, multi,
                                               overrides)
            record = analyse(counter, memory, meta, time.time() - t0,
                             target=target)
            record["mesh"] = mesh_kind
            record["status"] = "ok"
        except Exception as e:
            record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                      "status": "error", "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-4000:]}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{mesh_kind}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(record, f, indent=2, default=str)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--target", choices=sorted(TARGET_ROOFLINES),
                    default="gpu_sm",
                    help="modeled machine for the roofline terms (the traced "
                         "step itself is target-independent)")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("either --all or both --arch and --shape are required")

    cells = ([(a, s) for a in ARCHS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = 0
    for arch, shape in cells:
        for mesh_kind in meshes:
            path = os.path.join(args.out,
                                f"{arch}__{shape}__{mesh_kind}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[skip] {arch} {shape} {mesh_kind} (cached)")
                    continue
            t0 = time.time()
            rec = run_cell(arch, shape, mesh_kind, args.out,
                           target=args.target)
            dt = time.time() - t0
            status = rec["status"]
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (f"flops={rec['hlo_flops']:.3g} "
                         f"coll={rec['collectives']['total_bytes']:.3g}B "
                         f"dom={r['dominant']}")
            elif status == "error":
                extra = rec["error"][:160]
                failures += 1
            print(f"[{status}] {arch} {shape} {mesh_kind} ({dt:.0f}s) {extra}",
                  flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
