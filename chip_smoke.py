#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

It drives the port's main path, the paper's own loop: compile an ISAMIR
program against the modeled GPU (``gpu_sm(8)``), tune it on the card, and
launch the hand-written CUDA kernels with the plan.

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds the kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   all at once).
3. ``compile``: the main path's compiles (the 8 GEMMs, the 5 GRU
   projections and the 5 GRU cells) through the strict pipeline, whose
   ``VerifyPass`` checks each schedule before Lower (the line counts the
   compiles it let through), into a fresh ``ArtifactCache`` under
   ``build/repro_torch/`` that stays the default for the run; each fresh
   artifact is checked again by ``verify_artifact``.  A second pass with the in-process memo cleared and
   the cache read back from its file must compile nothing fresh and give
   the same artifacts (``to_dict`` but ``meta``).
   Then the graph tier's compiles: whisper-medium's decoder block (one
   layer at full width: D = 1024, 16 heads of 64, F = 4096; T = 8) and its
   trace config (D = 32), each unfused and fused (``fuse_epilogues``),
   traced and compiled with ``compile_graph`` against ``gpu_sm(8)`` through
   the same strict pipeline into the same cache; a second pass with the
   memo cleared must compile nothing fresh (``graph_compile`` line).
4. Four phases of the main path, each with every launch counter set to 0
   just before it and read just after (one ``launches`` line each):

   * ``plan`` — with an empty tuning cache as the default, so the tile is
     the compiler's: the 8 DeepBench GEMMs (paper Fig. 3) in f32 and in
     bf16 through ``scheduled_gemm`` (K1), then for each of the 4
     DeepBench GRU sizes (paper Fig. 4; E = H, T = 128), in f32 and in
     bf16, one K3 step at the tile of the compiler's GRU plan
     (``gru_cell`` at ``gru_tile``) and the sequence through ``FusedGRU``
     (K4 on its persistent route: K2's launch projects the input of all
     128 steps at ``plan_gemm``'s tile, storing G in f32, then one
     persistent kernel runs the recurrence); each such sequence must
     launch exactly one K2 and one persistent kernel, and no K3; then one
     f32 sequence at B = 8, E = 512, H = 10240, T = 4, wider than the
     persistent kernel can place, which must take the step route: T
     launches of K3 at the compiler's GRU tile and no K2 or persistent
     kernel;
   * ``tune`` — the port's tuner (``python -m repro_torch.search.tune
     --suite gemm --backend measure --target gpu_sm --trials 8``) on the 8
     GEMMs, K1 timed on the card, into a fresh cache file under
     ``build/repro_torch/``; one ``tune`` line per case;
   * ``tuned`` — with that cache as the default: ``scheduled_gemm`` on the
     8 GEMMs in f32 and bf16 (K1 at the tuned tile), and ``gemm_bias_act``
     (K2, ``tile=None``: the tuned tile) on the 8 GEMMs x {"", sigmoid,
     tanh, relu} x {f32, bf16} with bias uniform(-1, 1);
   * ``graph`` — the four compiled blocks run on the card
     (``CompiledGraph.execute``) on the tracer's ternary inputs
     (``block_inputs``): each ``pallas_gpu_gemm`` node is one K1 launch at
     the compiled plan's tile (``simt``, f32), each other node runs its
     program through ``interpret_program`` in float64 on the card; K1's
     launches must equal the graph's ``pallas_gpu_gemm`` nodes.

   K1 and K2 run on the main loop their dtype and K take (``wgmma``: bf16
   after one transposing pass of B; ``simt``: f32), with split-K where the
   tiles are fewer than the SMs; the ``launches`` lines also count the
   transposing passes (``gemm_transpose``) and split-K reduces
   (``gemm_reduce``), and K3's split-step reduces (``gru_cell_reduce``).

5. Holds each output against the plain PyTorch version on the same inputs,
   and times the kernel (its whole launch sequence), the plain version and
   one PyTorch library call computing the same function with CUDA events
   (inputs repeated, so L2 is warm where they fit in it).  One JSON line
   per case, with the launch (route, split, threads, shared memory, grid)
   and the registers and spills ``-Xptxas -v`` reported for the main loop's
   instantiation.  The ``gemm`` lines also give the device time of each
   kernel of K1's launch sequence (transposing pass, main loop, reduce)
   from a ``torch.profiler`` trace of 5 calls (``device_ms``).  The
   ``tuned_gemm`` lines time K1 at the tuned tile beside K1 at the plan
   tile.  The ``gru`` lines give, per size: K3's split, grid and copy
   route; K4's launches per sequence, its projection's tile and the
   persistent launch (blocks, columns a block, k-lanes, dynamic shared
   memory, rows and bytes of U kept in shared memory); registers and
   spills of both kernels; and device time by kernel from a profiler trace
   (``step_device_ms``: K3's step and reduce; ``seq_device_ms``: K4's
   projection, recurrence and the rest: packing copies and a memset).  The
   ``gru_bf16`` lines give the same for the bf16 step and sequence, beside
   ``torch.gru_cell`` and cuDNN's ``nn.GRU`` in bf16; the ``gru_step_route``
   line times the wide f32 sequence.  One ``graph`` line per compiled block:
   its nodes, K1 launches and stream nodes; every tensor it produced held
   against the torch float64 reference (``models.traceable.
   block_reference``, on the card): bit-exact where the reference's
   magnitude stays below 2^24, else within rtol 1e-5 and atol 1e-5 *
   max|ref| (the trace config must be bit-exact throughout); ``execute``
   event-timed (5 calls), and split by node kind (``node_ms``: each node
   rerun alone, event-timed, summed over the K1 nodes and the stream
   nodes), K1's and the rest's device time in one call (profiler), the
   reference's time, and the same block in eager torch f32
   (``torch.matmul``, TF32 off) as the library yardstick.
6. Prints the ``kernels`` line and, last, the device line.  Exits non-zero,
   before the device line, when a comparison fails, a kernel of a phase was
   never launched in it, a bf16 DeepBench GEMM did not take the wgmma route
   or a launch with fewer tiles than SMs did not split K, a K3 step at a
   DeepBench size launched fewer blocks than the card has SMs, a DeepBench
   K4 sequence launched other than one K2 and one persistent kernel or the
   wide one other than its T K3 steps, a compile failed verification or
   the second compile pass compiled anything fresh or gave another
   artifact, or the tuner failed or wrote fewer than 8 ``measure``
   records, or a block's K1 launches differ from its GEMM nodes or a
   tensor of it disagrees with the reference; when there is no card it
   prints nothing and exits 1.

Inputs: uniform(-1, 1) from ``np.random.default_rng(seed)``; the GRU
weights are uniform(-1/sqrt(H), 1/sqrt(H)), PyTorch's own GRU init.
Tolerances: GEMM f32 rtol 1e-5 and atol 1e-5 * max|want| — sums of up to
2560 products taken in another order than the plain version's (cuBLAS), so
the error scales with the outputs' magnitude (up to ~80 here); K2 f32 the
same with max|A @ B + bias|, the activation's input; GEMM and K2 bf16
rtol = atol = 2e-2 (``tests/test_kernels.py``); one GRU step (K3) rtol =
atol = 1e-5 and the GRU sequence rtol 1e-4, atol 1e-5
(``tests/test_kernels.py``); bf16 GRU steps and sequences rtol = atol =
2e-2, JAX's bf16 tolerance.
Bounds: the larger of bytes (each input read once, each output written
once) over 3.35 TB/s and operations (2mnk for a GEMM) over 67 TFLOP/s (f32,
CUDA cores) or 989 TFLOP/s (bf16) — NVIDIA H100 SXM data-sheet peaks at
700 W; a block's bound counts its inputs and output and its GEMMs' 2mnk.  K2's library call is ``torch.addmm(bias, A, B)`` followed by the
activation's torch op: two launches where there is an activation.  In the
``kernels`` line each time sums that kernel's calls over the main path's
shapes, one call per shape (for K3, one step; K1 at the tuned tile; K3
and K4 in f32 and bf16 at the DeepBench sizes), and ``launches`` sums the
four phases.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BW = 3.35e12
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}
GEMM_SIZES = [(1024, 128, 1024), (2048, 64, 2048), (1760, 128, 1760),
              (2560, 64, 2560), (5124, 700, 2048), (3072, 128, 1024),
              (35, 700, 2048), (7680, 1, 2560)]
GRU_SIZES = [(32, 512), (32, 1024), (16, 1536), (32, 1792)]
STEPS = 128
SHORT_STEPS = 2        # a sequence too short for an error to fade from h
#: (B, E, H, T) of the sequence wider than K4's persistent kernel places
#: (f32 on an H100: H > 9504), which takes the step route
WIDE_GRU = (8, 512, 10240, 4)
ACTS = ("", "sigmoid", "tanh", "relu")
TUNE_TRIALS = 8
GEMM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
GRU_TOL = (1e-4, 1e-5)
CELL_TOL = (1e-5, 1e-5)
BF16_TOL = (2e-2, 2e-2)
#: the graph phase: whisper-medium's decoder block (the one config of
#: ``configs/`` whose head dim, 64, is the power of four ``trace_block``
#: needs at full width) at the graph tier's default sequence length
GRAPH_ARCH = "whisper-medium"
GRAPH_SEQ = 8
#: below it an f32 tensor of integers is exact, and so is every sum that
#: builds it; above it K1's f32 sums round where the reference's do not
EXACT_BOUND = float(1 << 24)
#: rtol, and atol as a share of max|ref|, for tensors above EXACT_BOUND:
#: K1's f32 sums of up to 4096 products differ from float64 by a few parts
#: in 10^7 of max|ref| (the graph lines' max_err_over_max_ref), so 1e-5
#: leaves a margin of about 20x
GRAPH_TOL = (1e-5, 1e-5)
#: the kernels of K1's launch sequence, by name in a profiler trace
K1_KERNELS = {"k1": ("simt_kernel", "wgmma_kernel", "reduce_kernel",
                     "transpose_kernel")}


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


#: the kernels of K1's and K2's launch sequence, by name in a profiler trace
SEQUENCE_KERNELS = {"transpose": ("transpose_kernel",),
                    "main": ("simt_kernel", "wgmma_kernel"),
                    "reduce": ("reduce_kernel",)}


#: K3's kernels and K4's (projection: K2's main loop and split-K reduce;
#: the persistent recurrence); "other" in K4's is the rest of its device
#: time: the packing copies and the barrier counter's memset
STEP_KERNELS = {"step": ("gru_step_kernel",), "reduce": ("gru_sum_kernel",)}
SEQ_KERNELS = {"projection": ("simt_kernel", "wgmma_kernel", "reduce_kernel"),
               "recurrence": ("gru_seq_kernel",)}


def device_ms(fn, reps: int, parts=None, main: str = "main",
              other: bool = False) -> dict | None:
    """Device time per call of each kernel of a launch sequence (``parts``,
    by default K1/K2's ``SEQUENCE_KERNELS``), from a ``torch.profiler``
    trace of ``reps`` calls after a warm-up; with ``other``, the device
    time of every other kernel, copy and memset in the trace too.  ``None``
    when the trace holds no device time for ``main``."""
    from torch.profiler import ProfilerActivity, profile
    parts = parts or SEQUENCE_KERNELS
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(parts, 0.0)
    rest = 0.0
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / 1e3 / reps
        hit = [part for part, names in parts.items()
               if any(nm in ev.key for nm in names)]
        if hit:
            out[hit[0]] += ms
        else:
            rest += ms
    if not out[main]:
        return None
    if other:
        out["other"] = rest
    out["sum"] = sum(out.values())
    return out


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    """(least time in ms, what bounds it) on the data-sheet peaks."""
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def mismatch(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float
             ) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within atol + rtol|want|)."""
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and got.shape == want.shape \
        and bool((diff <= atol + rtol * want.float().abs()).all())
    return float(diff.max()), ok


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def library_gru_bf16(params: dict, x0: torch.Tensor, xs: torch.Tensor,
                     h0: torch.Tensor) -> dict:
    """Times of ``torch.gru_cell`` (one step) and cuDNN's ``nn.GRU`` (the
    sequence) on bf16 operands; a library that refuses bf16 gives ``None``
    and its error, since it is a yardstick and not part of the port."""
    inp, hidden = params["Wr"].shape
    w_ih = torch.cat([params["Wr"], params["Wz"], params["Wn"]], 1).T \
        .contiguous()
    w_hh = torch.cat([params["Ur"], params["Uz"], params["Un"]], 1).T \
        .contiguous()
    zeros = torch.zeros_like(params["br"])
    b_ih = torch.cat([params["br"], params["bz"], params["bnx"]])
    b_hh = torch.cat([zeros, zeros, params["bnh"]])
    out = {"step_ms": None, "seq_ms": None, "error": None}
    try:
        with torch.no_grad():
            out["step_ms"] = time_ms(
                lambda: torch.gru_cell(x0, h0, w_ih, w_hh, b_ih, b_hh), 50)
            lib = torch.nn.GRU(inp, hidden).to(xs.device, torch.bfloat16)
            lib.weight_ih_l0.copy_(w_ih)
            lib.weight_hh_l0.copy_(w_hh)
            lib.bias_ih_l0.copy_(b_ih)
            lib.bias_hh_l0.copy_(b_hh)
            out["seq_ms"] = time_ms(lambda: lib(xs, h0[None]), 5)
    except RuntimeError as exc:
        out["error"] = str(exc).splitlines()[0]
    return out


def eager_block(t: dict, cfg) -> torch.Tensor:
    """The traced decoder block in eager torch f32 (``torch.matmul``, TF32
    off), from the tensors ``t`` by the tracer's names: the graph phase's
    library yardstick, used nowhere in the port."""
    scale = 2.0 ** -((cfg.hd.bit_length() - 1) // 2)
    x = t["x"]
    y1 = x
    for h in range(cfg.n_heads):
        q, k, v = x @ t[f"wq{h}"], x @ t[f"wk{h}"], x @ t[f"wv{h}"]
        y1 = y1 + (torch.relu((q @ k.T) * scale) @ v) @ t[f"wo{h}"]
    hid = torch.relu(y1 @ t["w_gate"]) + y1 @ t["w_up"]
    return y1 + hid @ t["w_down"]


def hold_graph(got: dict, want: dict) -> dict:
    """Each tensor a block produced (``got``) against the float64
    reference (``want``, by the same names): bit-exact where max|ref| is
    below ``EXACT_BOUND``, else within ``GRAPH_TOL``."""
    out = {"exact_tensors": 0, "tolerance_tensors": 0, "max_ref": 0.0,
           "max_abs_err": 0.0, "max_err_over_max_ref": 0.0, "mismatched": []}
    for name, ref in want.items():
        if name not in got:
            continue
        mag = float(ref.abs().max())
        out["max_ref"] = max(out["max_ref"], mag)
        if mag < EXACT_BOUND:
            out["exact_tensors"] += 1
            ok = torch.equal(got[name], ref)
            err = float((got[name].double() - ref.double()).abs().max())
        else:
            out["tolerance_tensors"] += 1
            err, ok = mismatch(got[name], ref, GRAPH_TOL[0],
                               GRAPH_TOL[1] * mag)
            out["max_err_over_max_ref"] = max(out["max_err_over_max_ref"],
                                              err / mag)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if not ok:
            out["mismatched"].append(name)
    return out


def node_ms(cg, env: dict, dev, reps: int = 3) -> dict:
    """Where a block's ``execute`` time goes: each node rerun alone on its
    recorded inputs and event-timed (``reps`` calls, host path included),
    summed over the K1 nodes and over the other (stream) nodes."""
    from repro_torch.graph.execute import interpret_program, run_gemm_node
    out = {"k1_nodes": 0.0, "stream_nodes": 0.0}
    for node in cg.graph.nodes:
        lowering = cg.kernels[cg.node_kernels[node.name]].lowering
        ins = {b: env[t] for b, t in node.inputs}
        if lowering["kind"] == "stream":
            out["stream_nodes"] += time_ms(
                lambda: interpret_program(node.program, ins, dev), reps)
        else:
            out["k1_nodes"] += time_ms(
                lambda: run_gemm_node(node, lowering, ins), reps)
    return out


def entry(name, source, replaces, count, rs):
    """One kernel's line: times summed over the main path's shapes."""
    bounds = [r["bound"] for r in rs]
    by_ops = sum(b for b, by in bounds if by == "operations")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count,
            "max_abs_err": max(r["err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(b for b, _ in bounds),
            "bound_by": "operations"
            if by_ops >= sum(b for b, _ in bounds) / 2 else "bytes",
            "library_ms": None if any(r["library_ms"] is None for r in rs)
            else sum(r["library_ms"] for r in rs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.compile import (ArtifactCache, compile_gemm, compile_gru,
                                     set_default_artifact_cache)
    from repro_torch.compile import driver as compile_driver
    from repro_torch.compile.driver import clear_memo
    from repro_torch.compile.pipeline import DEFAULT_PASSES, VerifyPass
    from repro_torch.configs import get_config, get_trace_config
    from repro_torch.core.sysgraph import gpu_sm
    from repro_torch.graph import (block_inputs, compile_graph,
                                   fuse_epilogues, trace_block)
    from repro_torch.kernels import cuda, ref
    from repro_torch.kernels.gemm import (MIN_SPLIT_STEPS, block_tile,
                                          device_sms, gemm, gemm_bias_act,
                                          gemm_launch, gemm_reduce,
                                          gemm_transpose, kernel_resources,
                                          operand_route, route_tile,
                                          tuned_block)
    from repro_torch.kernels.gru import (STEP_KC, FusedGRU, PARAM_NAMES,
                                         device_smem, device_split, gru_cell,
                                         gru_cell_reduce, gru_seq,
                                         gru_seq_launch, pack_w, seq_route,
                                         step_route)
    from repro_torch.kernels.ops import (gru_tile, plan_gemm, plan_gru,
                                         scheduled_gemm)
    from repro_torch.models.traceable import block_reference
    from repro_torch.search import tune
    from repro_torch.search.cache import TuningCache, set_default_cache
    from repro_torch.verify import verify_artifact

    dev = torch.device("cuda")
    graph = gpu_sm(8)
    torch.backends.cudnn.allow_tf32 = False      # the library GRU's products
    print(nvidia_smi("name,power.limit"), flush=True)

    t0 = time.perf_counter()
    libs = cuda.build_kernels()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: os.path.relpath(p, ROOT) for n, p in libs.items()}})

    rng = np.random.default_rng(args.seed)

    def uniform(shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, size=shape).astype(np.float32)

    gemm_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for m, n, k in GEMM_SIZES:
            a = torch.from_numpy(uniform((m, k))).to(dev, dtype)
            b = torch.from_numpy(uniform((k, n))).to(dev, dtype)
            bias = torch.from_numpy(uniform((n,))).to(dev)
            gemm_cases.append({"mnk": (m, n, k), "dtype": dtype, "a": a,
                               "b": b, "bias": bias})
    gru_cases = []
    for batch, hidden in GRU_SIZES:
        inp, s = hidden, hidden ** -0.5
        params = {nm: uniform({"W": (inp, hidden), "U": (hidden, hidden),
                               "b": (hidden,)}[nm[0]], -s, s)
                  for nm in PARAM_NAMES}
        xs = torch.from_numpy(uniform((STEPS, batch, inp))).to(dev)
        h0 = torch.from_numpy(uniform((batch, hidden))).to(dev)
        gru_cases.append({
            "bh": (batch, hidden), "params": params,
            "model": FusedGRU.from_numpy(params, device=dev),
            "model_bf16": FusedGRU.from_numpy(params, device=dev,
                                              dtype=torch.bfloat16),
            "xs": xs, "h0": h0, "xs_bf16": xs.bfloat16(),
            "h0_bf16": h0.bfloat16()})
    # the wide sequence: weights made on the card from the seed (1.3 GB)
    wb, we, wh, wt = WIDE_GRU
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def card_uniform(shape, scale=1.0):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * scale

    wide_model = FusedGRU(we, wh, device=dev)
    with torch.no_grad():
        for nm in PARAM_NAMES:
            buf = getattr(wide_model, nm)
            buf.copy_(card_uniform(buf.shape, wh ** -0.5))
    wide = {"model": wide_model, "xs": card_uniform((wt, wb, we)),
            "h0": card_uniform((wb, wh))}
    torch.cuda.synchronize()

    counters = {"gemm": gemm, "gemm_bias_act": gemm_bias_act,
                "gru_cell": gru_cell, "gru_cell_reduce": gru_cell_reduce,
                "gru_seq": gru_seq, "gemm_transpose": gemm_transpose,
                "gemm_reduce": gemm_reduce}
    #: the counters of the kernels' own wrappers
    wrappers = ("gemm", "gemm_bias_act", "gru_cell", "gru_seq")
    phase_launches = {}
    failures = []
    sms = device_sms(dev)

    def launch_fields(a, b, tile, m, n, k):
        """The launch a K1/K2 call makes at ``tile`` (``grid_blocks``: x
        over N, y over M, z over the K slices) and what ptxas reported for
        its main loop; records a failure where a bf16 GEMM missed the wgmma
        route, or where fewer tiles than SMs did not split a K deep enough
        for two slices."""
        route = operand_route(a, b)
        tile = tile or route.default_tile
        ln = gemm_launch(m, n, k, a.dtype, tile, route, sms)
        res = kernel_resources(ln.route, a.dtype, ln.tile) or {}
        if a.dtype == torch.bfloat16 and ln.route != "wgmma":
            failures.append(f"bf16 {m}x{n}x{k} took the {ln.route} route")
        if ln.grid[0] * ln.grid[1] < sms and ln.split == 1 \
                and -(-k // ln.tile[2]) >= 2 * MIN_SPLIT_STEPS:
            failures.append(f"{m}x{n}x{k} {ln.tile}: {ln.grid} tiles on "
                            f"{sms} SMs and no split")
        return {"route": ln.route, "split": ln.split, "threads": ln.threads,
                "smem_bytes": ln.smem_bytes,
                "grid_blocks": [ln.grid[1], ln.grid[0], ln.split],
                "registers": res.get("registers"),
                "spill_bytes": res.get("spill_stores", 0)
                + res.get("spill_loads", 0) if res else None}

    @contextlib.contextmanager
    def counted(phase: str, path: tuple[str, ...]):
        """Counters at 0 just before the phase, read just after it; every
        kernel of the phase's path must have launched."""
        for c in counters.values():
            c.launches = 0
        yield
        torch.cuda.synchronize()
        got = {name: c.launches for name, c in counters.items()}
        phase_launches[phase] = got
        emit({"phase": phase, "launches": got})
        missing = [name for name in path if got[name] == 0]
        if missing:
            failures.append(f"{phase}: kernels never launched: {missing}")

    # ---- the main path's compiles: verified, cached, replayed ------------
    os.makedirs(cuda.BUILD_DIR, exist_ok=True)
    compiled_path = cuda.BUILD_DIR / f"compiled-{os.getpid()}-{time.time_ns()}.json"
    compiles = ([("gemm", m, n, k) for m, n, k in GEMM_SIZES]
                + [("gemm", STEPS * b, 3 * h, h) for b, h in GRU_SIZES]
                + [("gemm", wt * wb, 3 * wh, we)]
                + [("gru", b, h, h) for b, h in GRU_SIZES]
                + [("gru", wb, wh, we)])

    def compile_all():
        return [compile_gemm(*dims, graph=graph) if kind == "gemm"
                else compile_gru(*dims, graph=graph)
                for kind, *dims in compiles]

    def payload(art):
        return {k: v for k, v in art.to_dict().items() if k != "meta"}

    class CountedVerifyPass(VerifyPass):
        """The driver's VerifyPass, counting the compiles it let through."""

        passed = 0

        def run(self, ctx):
            super().run(ctx)
            CountedVerifyPass.passed += ctx.verify

    t0 = time.perf_counter()
    clear_memo()
    set_default_artifact_cache(ArtifactCache(str(compiled_path)))
    compile_driver.VerifyPass = CountedVerifyPass
    try:
        first = compile_all()
    finally:
        compile_driver.VerifyPass = VerifyPass
    fresh = [a for a in first if not a.from_cache]
    verified = sum(verify_artifact(a).ok for a in fresh)
    compile_s = time.perf_counter() - t0
    clear_memo()
    set_default_artifact_cache(ArtifactCache(str(compiled_path)))
    second = compile_all()
    refresh = sum(not a.from_cache for a in second)
    same = sum(payload(a) == payload(b) for a, b in zip(first, second))
    emit({"phase": "compile", "cache": os.path.relpath(compiled_path, ROOT),
          "passes": [ps.name for ps in DEFAULT_PASSES],
          "compiles": len(first), "fresh": len(fresh),
          "passed_verify_pass": CountedVerifyPass.passed,
          "verify_artifact_ok": verified,
          "seconds": compile_s, "cached_artifacts":
          len(ArtifactCache(str(compiled_path))),
          "second_pass_fresh": refresh, "second_pass_identical": same})
    if "verify" not in [ps.name for ps in DEFAULT_PASSES] or not fresh \
            or not CountedVerifyPass.passed == verified == len(fresh):
        failures.append(f"compile: {len(fresh)} fresh compiles, "
                        f"{CountedVerifyPass.passed} through VerifyPass, "
                        f"{verified} verified again")
    if refresh or same != len(first):
        failures.append(f"compile: the second pass compiled {refresh} fresh, "
                        f"{same} of {len(first)} artifacts identical")

    # ---- the graph tier's compiles: whisper-medium's decoder block -------
    blocks = []
    for size, cfg in (("full", get_config(GRAPH_ARCH).scaled(n_layers=1)),
                      ("trace", get_trace_config(GRAPH_ARCH))):
        g = trace_block(cfg, seq_len=GRAPH_SEQ)
        inputs = {t: torch.from_numpy(v).to(dev)
                  for t, v in block_inputs(g).items()}
        flops = 2.0 * sum(math.prod(a.size for a in n.program.axes)
                          for n in g.nodes if n.kind == "gemm")
        fg, decisions = fuse_epilogues(g)
        blocks += [{"size": size, "fused": fused, "cfg": cfg, "g": gg,
                    "decisions": dec, "inputs": inputs, "flops": flops}
                   for fused, gg, dec in ((False, g, []),
                                          (True, fg, decisions))]

    def compile_blocks():
        return [compile_graph(b["g"], graph, decisions=b["decisions"])
                for b in blocks]

    def kernel_payloads(cg):
        return {fp: payload(k) for fp, k in cg.kernels.items()}

    t0 = time.perf_counter()
    CountedVerifyPass.passed = 0
    compile_driver.VerifyPass = CountedVerifyPass
    try:
        first_graphs = compile_blocks()
    finally:
        compile_driver.VerifyPass = VerifyPass
    graph_compile_s = time.perf_counter() - t0
    clear_memo()
    set_default_artifact_cache(ArtifactCache(str(compiled_path)))
    second_graphs = compile_blocks()
    graph_rows = []
    for b, cg, cg2 in zip(blocks, first_graphs, second_graphs):
        b["cg"] = cg
        kinds = [cg.kernels[cg.node_kernels[n.name]].lowering["kind"]
                 for n in cg.graph.nodes]
        b["gemm_nodes"] = kinds.count("pallas_gpu_gemm")
        b["stream_nodes"] = kinds.count("stream")
        graph_rows.append({"graph": cg.name, "fused": b["fused"],
                     "nodes": len(kinds), "gemm_nodes": b["gemm_nodes"],
                     "stream_nodes": b["stream_nodes"],
                     "unique_programs": cg.stats["unique_programs"],
                     "fresh": cg.stats["fresh_compiles"],
                     "cache_hits": cg.stats["cache_hits"],
                     "second_pass_fresh": cg2.stats["fresh_compiles"],
                     "second_pass_identical":
                     kernel_payloads(cg) == kernel_payloads(cg2),
                     "modeled_makespan_s": cg.makespan})
    graph_fresh = sum(r["fresh"] for r in graph_rows)
    emit({"phase": "graph_compile", "target": graph.name,
          "seconds": graph_compile_s, "fresh": graph_fresh,
          "passed_verify_pass": CountedVerifyPass.passed,
          "graphs": graph_rows})
    if not graph_fresh or CountedVerifyPass.passed != graph_fresh:
        failures.append(f"graph compile: {graph_fresh} fresh compiles, "
                        f"{CountedVerifyPass.passed} through VerifyPass")
    if any(r["second_pass_fresh"] or not r["second_pass_identical"]
           for r in graph_rows):
        failures.append("graph compile: the second pass compiled something "
                        "fresh or gave another artifact")

    # ---- main path, phase plan: the compiler's tile ----------------------
    empty = cuda.BUILD_DIR / f"tuning-empty-{os.getpid()}.json"
    set_default_cache(TuningCache(str(empty)))
    def snapshot():
        return {name: c.launches for name, c in counters.items()}

    with counted("plan", ("gemm", "gemm_bias_act", "gru_cell",
                          "gru_cell_reduce", "gru_seq")):
        for c in gemm_cases:
            c["out"], c["cfg"] = scheduled_gemm(c["a"], c["b"], graph=graph)
        def sequence(model, xs, h0):
            """The sequence through ``FusedGRU``, and the launches of each
            kernel's wrapper it made (K2's transposing pass and split-K
            reduce and K3's reduce are parts of those launches)."""
            before = snapshot()
            out = model(xs, h0)
            return out, {n: v - before[n] for n, v in snapshot().items()
                         if v > before[n] and n in wrappers}

        for c in gru_cases:
            batch, hidden = c["bh"]
            c["block"], _ = plan_gru(batch, hidden, hidden, graph=graph)
            c["tile"] = gru_tile(c["block"])
            for sfx, x_key, h_key, model in (
                    ("", "xs", "h0", c["model"]),
                    ("_bf16", "xs_bf16", "h0_bf16", c["model_bf16"])):
                c["step_out" + sfx] = gru_cell(c[x_key][0], c[h_key],
                                               model.params(), tile=c["tile"])
                c["out" + sfx], c["seq_launches" + sfx] = sequence(
                    model, c[x_key], c[h_key])
                if c["seq_launches" + sfx] != {"gemm_bias_act": 1,
                                               "gru_seq": 1}:
                    failures.append(
                        f"gru {batch}x{hidden}{sfx}: a sequence launched "
                        f"{c['seq_launches' + sfx]}, not one K2 projection "
                        "and one persistent kernel")
        wide["out"], wide["seq_launches"] = sequence(wide["model"], wide["xs"],
                                                     wide["h0"])
        if wide["seq_launches"].get("gru_cell") != wt or any(
                wide["seq_launches"].get(n) for n in ("gemm_bias_act",
                                                      "gru_seq")):
            failures.append(f"gru {wb}x{wh}: the wide sequence launched "
                            f"{wide['seq_launches']}, not {wt} K3 steps")

    # ---- main path, phase tune: K1 measured into a fresh cache -----------
    cache_path = cuda.BUILD_DIR / f"tuning-{os.getpid()}-{time.time_ns()}.json"
    report_path = cache_path.with_suffix(".report.json")
    t0 = time.perf_counter()
    with counted("tune", ("gemm",)):
        with contextlib.redirect_stdout(sys.stderr):
            tune_rc = tune.main([
                "--suite", "gemm", "--backend", "measure",
                "--target", "gpu_sm", "--trials", str(TUNE_TRIALS),
                "--seed", str(args.seed), "--cache", str(cache_path),
                "--json", str(report_path)])
    tune_s = time.perf_counter() - t0
    if tune_rc != 0:
        failures.append(f"tuner exited {tune_rc}")
    tuned_cache = TuningCache(str(cache_path))
    records = {r.meta.get("case"): r for r in tuned_cache.load().values()
               if r.backend == "measure"}
    rows = json.loads(report_path.read_text())["rows"] \
        if report_path.exists() else []
    for row in rows:
        rec = records.get(row["case"])
        emit({"phase": "tune", "case": row["case"],
              "greedy_cost_s": row["greedy_cost_s"],
              "tuned_cost_s": row["tuned_cost_s"],
              "block": list(rec.tile) if rec else None,
              "tile": list(block_tile(rec.tile)) if rec else None,
              "measured_best_ms": row["measured_s"] * 1e3
              if row["measured_s"] is not None else None,
              "tiles_ms": {t: v * 1e3 for t, v in
                           rec.meta.get("tiles_s", {}).items()} if rec else None,
              "trials": row["trials"], "oracle_exact": row["exact"],
              "validated": row["validated"]})
    emit({"phase": "tune", "seconds": tune_s, "measure_records": len(records),
          "device": next(iter(records.values())).meta.get("device")
          if records else None})
    if len(records) < len(GEMM_SIZES):
        failures.append(f"the tuner wrote {len(records)} measure records, "
                        f"not {len(GEMM_SIZES)}")

    # ---- main path, phase tuned: K1 and K2 at the tuned tile -------------
    set_default_cache(tuned_cache)
    with counted("tuned", ("gemm", "gemm_bias_act")):
        for c in gemm_cases:
            c["tuned_out"], c["tuned_cfg"] = scheduled_gemm(c["a"], c["b"],
                                                            graph=graph)
            c["k2_out"] = {fn: gemm_bias_act(c["a"], c["b"], c["bias"], fn)
                           for fn in ACTS}

    # ---- main path, phase graph: the compiled blocks on the card ---------
    with counted("graph", ("gemm",)):
        for b in blocks:
            before = counters["gemm"].launches
            b["env"] = b["cg"].execute(b["inputs"], device=dev,
                                       return_all=True)
            b["k1_launches"] = counters["gemm"].launches - before
    for b in blocks:
        if b["k1_launches"] != b["gemm_nodes"]:
            failures.append(f"graph {b['cg'].name}: {b['k1_launches']} K1 "
                            f"launches for {b['gemm_nodes']} GEMM nodes")

    # ---- held against the plain versions, and timed -----------------------
    k1, k2 = [], []
    for c in gemm_cases:
        a, b, bias, dtype, (m, n, k) = (c["a"], c["b"], c["bias"], c["dtype"],
                                        c["mnk"])
        want = ref.gemm_ref(a, b)
        rtol, atol = GEMM_TOL[dtype]
        if dtype == torch.float32:
            atol *= float(want.abs().max())
        err, ok = mismatch(c["out"], want, rtol, atol)
        tile = c["cfg"].tile
        reps = 20
        kernel_ms = time_ms(lambda: gemm(a, b, tile=tile), reps)
        dev_ms = device_ms(lambda: gemm(a, b, tile=tile), 5)
        plain_ms = time_ms(lambda: ref.gemm_ref(a, b), reps)
        library_ms = time_ms(lambda: torch.matmul(a, b), reps)
        bound_ms, bound_by = bound(a.element_size() * (m * k + k * n + m * n),
                                   2.0 * m * n * k, dtype)
        emit({"phase": "gemm", "m": m, "n": n, "k": k,
              "dtype": dtype_name(dtype),
              "block": list(c["cfg"].block), "tile": list(tile),
              **launch_fields(a, b, tile, m, n, k),
              "kernel_ms": kernel_ms, "device_ms": dev_ms,
              "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "max_abs_err": err, "rtol": rtol,
              "atol": atol, "ok": ok})
        if not ok:
            failures.append(f"gemm {m}x{n}x{k} {dtype}: max err {err}")

        # K1 at the tuned tile, timed beside the plan tile in turns
        tuned = c["tuned_cfg"]
        t_err, t_ok = mismatch(c["tuned_out"], want, rtol, atol)
        plan_ms = time_ms(lambda: gemm(a, b, tile=tile), reps)
        tuned_ms = time_ms(lambda: gemm(a, b, tile=tuned.tile), reps)
        tuned_ms2 = time_ms(lambda: gemm(a, b, tile=tuned.tile), reps)
        plan_ms2 = time_ms(lambda: gemm(a, b, tile=tile), reps)
        emit({"phase": "tuned_gemm", "m": m, "n": n, "k": k,
              "dtype": dtype_name(dtype), "tuned_block": list(tuned.block),
              "tuned_tile": list(tuned.tile), "plan_tile": list(tile),
              **launch_fields(a, b, tuned.tile, m, n, k),
              "tuned_ms": (tuned_ms + tuned_ms2) / 2,
              "plan_ms": (plan_ms + plan_ms2) / 2,
              "max_abs_err": t_err, "ok": t_ok})
        k1.append({"ms": (tuned_ms + tuned_ms2) / 2, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound": (bound_ms, bound_by),
                   "err": max(err, t_err)})
        if not t_ok:
            failures.append(f"tuned gemm {m}x{n}x{k} {dtype}: max err {t_err}")

        # K2: every activation, at the tuned tile
        block = tuned_block(m, n, k)
        k2_tile = route_tile(block, operand_route(a, b)) if block else None
        k2_launch = launch_fields(a, b, k2_tile, m, n, k)
        pre_max = float((a.float() @ b.float() + bias).abs().max())
        lib_bias = bias.to(dtype)
        k2_bound = bound(a.element_size() * (m * k + k * n + m * n) + 4 * n,
                         2.0 * m * n * k, dtype)
        for fn in ACTS:
            want = ref.gemm_bias_act_ref(a, b, bias, fn)
            rtol, atol = GEMM_TOL[dtype]
            if dtype == torch.float32:
                atol *= pre_max
            err, ok = mismatch(c["k2_out"][fn], want, rtol, atol)
            act = ref.ACTIVATIONS[fn]
            kernel_ms = time_ms(
                lambda: gemm_bias_act(a, b, bias, fn, tile=k2_tile), reps)
            plain_ms = time_ms(
                lambda: ref.gemm_bias_act_ref(a, b, bias, fn), reps)
            library_ms = time_ms(
                lambda: act(torch.addmm(lib_bias, a, b)), reps)
            emit({"phase": "gemm_bias_act", "m": m, "n": n, "k": k,
                  "dtype": dtype_name(dtype), "fn": fn,
                  "tile": list(k2_tile) if k2_tile else None, **k2_launch,
                  "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                  "library_ms": library_ms,
                  "library": "torch.addmm" + (f" + torch.{fn}" if fn else ""),
                  "library_launches": 2 if fn else 1,
                  "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
                  "max_abs_err": err, "rtol": rtol, "atol": atol, "ok": ok})
            k2.append({"ms": kernel_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound": k2_bound,
                       "err": err})
            if not ok:
                failures.append(f"gemm_bias_act {m}x{n}x{k} {dtype} {fn!r}: "
                                f"max err {err}")

    def gru_resources(pattern: str) -> dict | None:
        """Registers and spill bytes ``-Xptxas -v`` reported for the GRU
        kernel whose mangled name matches ``pattern``."""
        found = [v for name, v in cuda.ptxas_report("gru").items()
                 if re.search(pattern, name)]
        if not found:
            return None
        return {"registers": found[0].get("registers"),
                "spill_bytes": found[0].get("spill_stores", 0)
                + found[0].get("spill_loads", 0)}

    smem_limit = device_smem(dev)
    k3, k4 = [], []
    for c in gru_cases:
        (batch, hidden), xs, h0 = c["bh"], c["xs"], c["h0"]
        inp = hidden
        params = c["model"].params()
        block, tile = c["block"], c["tile"]
        want = ref.gru_seq_ref(xs, h0, params)
        err, ok = mismatch(c["out"], want, *GRU_TOL)
        if not ok:
            failures.append(f"gru {batch}x{hidden}: max err {err}")
        x0 = xs[0]
        step_err, step_ok = mismatch(c["step_out"],
                                     ref.gru_cell_ref(x0, h0, params),
                                     *CELL_TOL)
        if not step_ok:
            failures.append(f"gru_cell {batch}x{hidden}: max err {step_err}")
        # K3's launch: the split, and blocks = tiles x slices
        route = step_route(inp, hidden)
        split = device_split(batch, inp, hidden, tile, dev, route)
        step_blocks = -(-hidden // tile[1]) * -(-batch // tile[0]) * split
        if step_blocks < sms:
            failures.append(f"gru_cell {batch}x{hidden}: {step_blocks} blocks "
                            f"on {sms} SMs")
        step_res = gru_resources(
            rf"gru_step_kernelIfLi{tile[0]}ELi{tile[1]}ELb"
            f"{int(route == 'vec4')}E")
        # K4's launches: the projection's tile and the persistent partition
        proj_cfg, _ = plan_gemm(STEPS * batch, 3 * hidden, inp, graph=graph)
        seq_launch = gru_seq_launch(batch, inp, hidden, sms, smem_limit)
        seq_res = gru_resources(
            rf"gru_seq_kernelIfLb{int(hidden % 4 == 0)}E")
        # K2 at the projection's shape, held against its plain version at
        # K2's f32 tolerance: G's early rows fade from h_T, so the sequence's
        # check alone would not see a fault there
        x2d = xs.view(STEPS * batch, inp)
        w_cat, b_cat = pack_w(params)
        proj_want = ref.gemm_bias_act_ref(x2d, w_cat, b_cat, "")
        proj_rtol, proj_atol = GEMM_TOL[torch.float32]
        proj_atol *= float(proj_want.abs().max())
        proj_err, proj_ok = mismatch(
            gemm_bias_act(x2d, w_cat, b_cat, "", tile=proj_cfg.tile),
            proj_want, proj_rtol, proj_atol)
        if not proj_ok:
            failures.append(f"gru {batch}x{hidden}: projection "
                            f"{STEPS * batch}x{3 * hidden}x{inp} max err "
                            f"{proj_err}")
        # a short sequence, where an error in the recurrence cannot fade
        short_err, short_ok = mismatch(
            gru_seq(xs[:SHORT_STEPS], h0, params, proj_tile=proj_cfg.tile),
            ref.gru_seq_ref(xs[:SHORT_STEPS], h0, params), *GRU_TOL)
        if not short_ok:
            failures.append(f"gru {batch}x{hidden} T={SHORT_STEPS}: max err "
                            f"{short_err}")
        # library: PyTorch's own GRU cell and cuDNN's GRU, gates (r, z, n)
        w_ih = torch.cat([params["Wr"], params["Wz"], params["Wn"]], 1).T
        w_hh = torch.cat([params["Ur"], params["Uz"], params["Un"]], 1).T
        zeros = torch.zeros_like(params["br"])
        b_ih = torch.cat([params["br"], params["bz"], params["bnx"]])
        b_hh = torch.cat([zeros, zeros, params["bnh"]])
        lib_gru = torch.nn.GRU(inp, hidden).to(dev)
        with torch.no_grad():
            lib_gru.weight_ih_l0.copy_(w_ih)
            lib_gru.weight_hh_l0.copy_(w_hh)
            lib_gru.bias_ih_l0.copy_(b_ih)
            lib_gru.bias_hh_l0.copy_(b_hh)
            lib_err = float((lib_gru(xs, h0[None])[1][0] - want).abs().max())
            w_ih, w_hh = w_ih.contiguous(), w_hh.contiguous()
            out = torch.empty_like(h0)

            def step():
                return gru_cell(x0, h0, params, tile=tile, out=out)

            def seq():
                return gru_seq(xs, h0, params, proj_tile=proj_cfg.tile)

            step_ms = time_ms(step, 50)
            step_dev = device_ms(step, 10, STEP_KERNELS, "step")
            step_plain_ms = time_ms(
                lambda: ref.gru_cell_ref(x0, h0, params), 50)
            step_lib_ms = time_ms(
                lambda: torch.gru_cell(x0, h0, w_ih, w_hh, b_ih, b_hh), 50)
            seq_ms = time_ms(seq, 5)
            seq_dev = device_ms(seq, 3, SEQ_KERNELS, "recurrence", other=True)
            seq_plain_ms = time_ms(lambda: ref.gru_seq_ref(xs, h0, params), 5)
            seq_lib_ms = time_ms(lambda: lib_gru(xs, h0[None]), 5)
        w_bytes = 4 * (3 * inp * hidden + 3 * hidden * hidden + 4 * hidden)
        step_flops = 2.0 * batch * hidden * 3 * (inp + hidden)
        step_bound = bound(w_bytes + 4 * batch * (inp + 2 * hidden),
                           step_flops, torch.float32)
        seq_bound = bound(w_bytes + 4 * (STEPS * batch * inp + 2 * batch * hidden),
                          STEPS * step_flops, torch.float32)
        emit({"phase": "gru", "batch": batch, "hidden": hidden, "inp": inp,
              "steps": STEPS, "block": list(block), "tile": list(tile),
              "step_split": split, "step_grid_blocks": step_blocks,
              "step_route": route, "step_kc": STEP_KC,
              "step_resources": step_res,
              "step_ms": step_ms, "step_device_ms": step_dev,
              "step_plain_ms": step_plain_ms,
              "step_library_ms": step_lib_ms, "step_bound_ms": step_bound[0],
              "step_bound_by": step_bound[1],
              "seq_launches": c["seq_launches"],
              "projection_tile": list(proj_cfg.tile),
              "projection_split": proj_cfg.split,
              "persistent": {
                  "blocks": seq_launch.blocks, "cols": seq_launch.cols,
                  "batch_rows": seq_launch.batch,
                  "threads": seq_launch.threads, "lanes": seq_launch.lanes,
                  "smem_bytes": seq_launch.smem_bytes,
                  "u_rows_on_chip": seq_launch.rows_on_chip,
                  "u_bytes_on_chip": seq_launch.u_bytes_on_chip,
                  "u_bytes": seq_launch.u_bytes},
              "seq_resources": seq_res,
              "seq_ms": seq_ms, "seq_device_ms": seq_dev,
              "seq_plain_ms": seq_plain_ms,
              "seq_library_ms": seq_lib_ms, "seq_bound_ms": seq_bound[0],
              "seq_bound_by": seq_bound[1],
              "steps_x_step_bound_ms": STEPS * step_bound[0],
              "step_max_abs_err": step_err, "max_abs_err": err,
              "projection_max_abs_err": proj_err,
              "projection_rtol": proj_rtol, "projection_atol": proj_atol,
              "short_steps": SHORT_STEPS, "short_max_abs_err": short_err,
              "library_max_abs_err": lib_err, "rtol": GRU_TOL[0],
              "atol": GRU_TOL[1], "ok": ok and step_ok and proj_ok and short_ok})
        k3.append({"ms": step_ms, "plain_ms": step_plain_ms,
                   "library_ms": step_lib_ms, "bound": step_bound,
                   "err": step_err})
        k4.append({"ms": seq_ms, "plain_ms": seq_plain_ms,
                   "library_ms": seq_lib_ms, "bound": seq_bound, "err": err})

        # the same size in bf16: operands of 2 bytes, G and the math f32
        bf = torch.bfloat16
        pb, xb, hb = c["model_bf16"].params(), c["xs_bf16"], c["h0_bf16"]
        x0b = xb[0]
        b_step_err, b_step_ok = mismatch(c["step_out_bf16"],
                                         ref.gru_cell_ref(x0b, hb, pb),
                                         *BF16_TOL)
        b_err, b_ok = mismatch(c["out_bf16"], ref.gru_seq_ref(xb, hb, pb),
                               *BF16_TOL)
        if not (b_step_ok and b_ok):
            failures.append(f"gru bf16 {batch}x{hidden}: step max err "
                            f"{b_step_err}, sequence max err {b_err}")
        b_split = device_split(batch, inp, hidden, tile, dev, route, bf)
        b_launch = gru_seq_launch(batch, inp, hidden, sms, smem_limit, bf)
        b_proj, _ = plan_gemm(STEPS * batch, 3 * hidden, inp, dtype=bf,
                              graph=graph)
        b_out = torch.empty_like(hb)

        def b_step():
            return gru_cell(x0b, hb, pb, tile=tile, out=b_out)

        def b_seq():
            return gru_seq(xb, hb, pb, proj_tile=b_proj.tile)

        b_lib = library_gru_bf16(pb, x0b, xb, hb)
        b_step_ms = time_ms(b_step, 50)
        b_step_dev = device_ms(b_step, 10, STEP_KERNELS, "step")
        b_step_plain = time_ms(lambda: ref.gru_cell_ref(x0b, hb, pb), 50)
        b_seq_ms = time_ms(b_seq, 5)
        b_seq_dev = device_ms(b_seq, 3, SEQ_KERNELS, "recurrence", other=True)
        b_seq_plain = time_ms(lambda: ref.gru_seq_ref(xb, hb, pb), 5)
        b_w_bytes = 2 * (3 * inp * hidden + 3 * hidden * hidden + 4 * hidden)
        b_step_bound = bound(b_w_bytes + 2 * batch * (inp + 2 * hidden),
                             step_flops, bf)
        b_seq_bound = bound(
            b_w_bytes + 2 * (STEPS * batch * inp + 2 * batch * hidden),
            STEPS * step_flops, bf)
        emit({"phase": "gru_bf16", "batch": batch, "hidden": hidden,
              "inp": inp, "steps": STEPS, "tile": list(tile),
              "step_split": b_split, "step_route": route,
              "step_resources": gru_resources(
                  rf"gru_step_kernelI13__nv_bfloat16Li{tile[0]}ELi{tile[1]}"
                  f"ELb{int(route == 'vec4')}E"),
              "step_ms": b_step_ms, "step_device_ms": b_step_dev,
              "step_plain_ms": b_step_plain,
              "step_library_ms": b_lib["step_ms"],
              "step_bound_ms": b_step_bound[0],
              "step_bound_by": b_step_bound[1],
              "seq_launches": c["seq_launches_bf16"],
              "projection_tile": list(b_proj.tile),
              "projection_route": b_proj.route,
              "persistent": {
                  "blocks": b_launch.blocks, "cols": b_launch.cols,
                  "batch_rows": b_launch.batch, "lanes": b_launch.lanes,
                  "smem_bytes": b_launch.smem_bytes,
                  "u_rows_on_chip": b_launch.rows_on_chip,
                  "u_bytes_on_chip": b_launch.u_bytes_on_chip,
                  "u_bytes": b_launch.u_bytes},
              "seq_resources": gru_resources(
                  rf"gru_seq_kernelI13__nv_bfloat16Lb{int(hidden % 8 == 0)}E"),
              "seq_ms": b_seq_ms, "seq_device_ms": b_seq_dev,
              "seq_plain_ms": b_seq_plain,
              "seq_library_ms": b_lib["seq_ms"],
              "library_error": b_lib["error"],
              "seq_bound_ms": b_seq_bound[0],
              "seq_bound_by": b_seq_bound[1],
              "step_max_abs_err": b_step_err, "max_abs_err": b_err,
              "rtol": BF16_TOL[0], "atol": BF16_TOL[1],
              "ok": b_step_ok and b_ok})
        k3.append({"ms": b_step_ms, "plain_ms": b_step_plain,
                   "library_ms": b_lib["step_ms"], "bound": b_step_bound,
                   "err": b_step_err})
        k4.append({"ms": b_seq_ms, "plain_ms": b_seq_plain,
                   "library_ms": b_lib["seq_ms"], "bound": b_seq_bound,
                   "err": b_err})

    # the wide f32 sequence on the step route: T launches of K3
    wp = wide["model"].params()
    w_want = ref.gru_seq_ref(wide["xs"], wide["h0"], wp)
    w_err, w_ok = mismatch(wide["out"], w_want, *GRU_TOL)
    if not w_ok:
        failures.append(f"gru {wb}x{wh} step route: max err {w_err}")
    w_tile = gru_tile(plan_gru(wb, wh, we, graph=graph)[0])
    w_ms = time_ms(lambda: gru_seq(wide["xs"], wide["h0"], wp,
                                   step_tile=w_tile), 3)
    w_plain = time_ms(lambda: ref.gru_seq_ref(wide["xs"], wide["h0"], wp), 3)
    w_flops = 2.0 * wb * wh * 3 * (we + wh)
    w_bound = bound(4 * (3 * we * wh + 3 * wh * wh + 4 * wh)
                    + 4 * (wt * wb * we + 2 * wb * wh), wt * w_flops,
                    torch.float32)
    emit({"phase": "gru_step_route", "batch": wb, "inp": we, "hidden": wh,
          "steps": wt,
          "route": seq_route(wb, we, wh, torch.float32, sms, smem_limit),
          "tile": list(w_tile),
          "split": device_split(wb, we, wh, w_tile, dev, step_route(we, wh)),
          "seq_launches": wide["seq_launches"], "seq_ms": w_ms,
          "seq_plain_ms": w_plain, "seq_bound_ms": w_bound[0],
          "seq_bound_by": w_bound[1], "max_abs_err": w_err,
          "rtol": GRU_TOL[0], "atol": GRU_TOL[1], "ok": w_ok})

    # the compiled blocks against the float64 reference, and timed
    for b in blocks:
        cg, cfg, inputs = b["cg"], b["cfg"], b["inputs"]
        want = block_reference(inputs, cfg, GRAPH_SEQ, device=dev,
                               return_all=True)
        held = hold_graph(b["env"], want)
        if held["mismatched"] or (b["size"] == "trace"
                                  and held["tolerance_tensors"]):
            failures.append(f"graph {cg.name}: tensors off the reference: "
                            f"{held['mismatched']}, "
                            f"{held['tolerance_tensors']} above 2^24")
        with torch.no_grad():
            lib_out = eager_block(inputs, cfg)
        lib_err = float((lib_out.double() - want["y2"].double()).abs().max())
        nbytes = sum(cg.graph.tensors[t].nbytes
                     for t in (*cg.graph.inputs, *cg.graph.outputs))
        g_bound = bound(nbytes, b["flops"], torch.float32)
        run = lambda: cg.execute(inputs, device=dev)    # noqa: E731
        emit({"phase": "graph", "graph": cg.name, "size": b["size"],
              "fused": b["fused"], "d_model": cfg.d_model,
              "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "seq": GRAPH_SEQ,
              "nodes": len(cg.graph.nodes), "gemm_nodes": b["gemm_nodes"],
              "k1_launches": b["k1_launches"],
              "stream_nodes": b["stream_nodes"], **held,
              "execute_ms": time_ms(run, 5),
              "node_ms": node_ms(cg, b["env"], dev),
              "device_ms": device_ms(run, 3, K1_KERNELS, "k1", other=True),
              "reference_ms": time_ms(lambda: block_reference(
                  inputs, cfg, GRAPH_SEQ, device=dev), 5),
              "library_ms": time_ms(lambda: eager_block(inputs, cfg), 5),
              "library": "eager torch f32 (torch.matmul, TF32 off)",
              "library_max_err_over_max_ref":
              lib_err / float(want["y2"].abs().max()),
              "bytes": nbytes, "gflop": b["flops"] / 1e9,
              "bound_ms": g_bound[0], "bound_by": g_bound[1],
              "ok": not held["mismatched"]})

    launches = {name: sum(p[name] for p in phase_launches.values())
                for name in counters}
    kernels = [
        entry("gemm", "src/repro_torch/csrc/gemm.cu",
              "src/repro/kernels/gemm.py:103", launches["gemm"], k1),
        entry("gemm_bias_act", "src/repro_torch/csrc/gemm.cu",
              "src/repro/kernels/gemm.py:157", launches["gemm_bias_act"], k2),
        entry("gru_cell", "src/repro_torch/csrc/gru.cu",
              "src/repro/kernels/gru.py:83", launches["gru_cell"], k3),
        entry("gru_seq", "src/repro_torch/csrc/gru.cu",
              "src/repro/kernels/gru.py:105", launches["gru_seq"], k4),
    ]
    emit({"clocks_power": nvidia_smi(
        "clocks.sm,power.draw,power.limit,temperature.gpu")})
    emit({"kernels": kernels})
    unlaunched = [k["name"] for k in kernels if k["launches"] == 0]
    if unlaunched:
        failures.append(f"kernels never launched on the main path: {unlaunched}")
    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
