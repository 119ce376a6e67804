#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

It drives the port's main path, the paper's own loop: compile an ISAMIR
program against the modeled GPU (``gpu_sm(8)``), take the tile plan out of
the ``CompiledKernel`` and launch the hand-written CUDA kernels with it.

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds the kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   all at once).
3. Main path, with every launch counter set to 0 just before it and read
   just after: the 8 DeepBench GEMMs (paper Fig. 3) in f32 and in bf16
   through ``scheduled_gemm`` (K1), then the 4 DeepBench GRU sizes (paper
   Fig. 4; E = H, T = 128) through ``FusedGRU`` (K4 over K3).
4. Holds each output against the plain PyTorch version on the same inputs,
   and times the kernel, the plain version and one PyTorch library call
   computing the same function with CUDA events (inputs repeated, so L2 is
   warm where they fit in it).  One JSON line per case.
5. Prints the ``kernels`` line and, last, the device line.  Exits non-zero,
   before the device line, when a comparison fails or a kernel of the path
   was never launched; when there is no card it prints nothing and exits 1.

Inputs: uniform(-1, 1) from ``np.random.default_rng(seed)``; the GRU
weights are uniform(-1/sqrt(H), 1/sqrt(H)), PyTorch's own GRU init.
Tolerances: GEMM f32 rtol 1e-5 and atol 1e-5 * max|want| — sums of up to
2560 products taken in another order than the plain version's (cuBLAS), so
the error scales with the outputs' magnitude (up to ~80 here); GEMM bf16
rtol = atol = 2e-2 (``tests/test_kernels.py``); one GRU step (K3) rtol =
atol = 1e-5 and the GRU sequence rtol 1e-4, atol 1e-5
(``tests/test_kernels.py``).
Bounds: the larger of bytes (each input read once, each output written
once) over 3.35 TB/s and operations over 67 TFLOP/s (f32, CUDA cores) or
989 TFLOP/s (bf16) — NVIDIA H100 SXM data-sheet peaks at 700 W.  In the
``kernels`` line each time sums that kernel's calls over the main path's
shapes, one call per shape (for K3, one step).
"""
from __future__ import annotations

import argparse
import json
import os
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
GEMM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
GRU_TOL = (1e-4, 1e-5)
CELL_TOL = (1e-5, 1e-5)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.sysgraph import gpu_sm
    from repro_torch.kernels import cuda, ref
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.gru import FusedGRU, PARAM_NAMES, gru_cell, gru_seq
    from repro_torch.kernels.ops import (gru_tile, plan_gru, scheduled_gemm)

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
            gemm_cases.append({"mnk": (m, n, k), "dtype": dtype, "a": a, "b": b})
    gru_cases = []
    for batch, hidden in GRU_SIZES:
        inp, s = hidden, hidden ** -0.5
        params = {nm: uniform({"W": (inp, hidden), "U": (hidden, hidden),
                               "b": (hidden,)}[nm[0]], -s, s)
                  for nm in PARAM_NAMES}
        gru_cases.append({
            "bh": (batch, hidden), "params": params,
            "model": FusedGRU.from_numpy(params, device=dev),
            "xs": torch.from_numpy(uniform((STEPS, batch, inp))).to(dev),
            "h0": torch.from_numpy(uniform((batch, hidden))).to(dev)})
    torch.cuda.synchronize()

    # ---- the main path, counted -------------------------------------------
    gemm.launches = gru_cell.launches = gru_seq.launches = 0
    for c in gemm_cases:
        c["out"], c["cfg"] = scheduled_gemm(c["a"], c["b"], graph=graph)
    for c in gru_cases:
        c["out"] = c["model"](c["xs"], c["h0"])
    torch.cuda.synchronize()
    launches = {"gemm": gemm.launches, "gru_cell": gru_cell.launches,
                "gru_seq": gru_seq.launches}

    # ---- held against the plain versions, and timed -----------------------
    failures = []
    k1 = []
    for c in gemm_cases:
        a, b, dtype, (m, n, k) = c["a"], c["b"], c["dtype"], c["mnk"]
        want = ref.gemm_ref(a, b)
        rtol, atol = GEMM_TOL[dtype]
        if dtype == torch.float32:
            atol *= float(want.abs().max())
        err, ok = mismatch(c["out"], want, rtol, atol)
        tile = c["cfg"].tile
        reps = 20
        kernel_ms = time_ms(lambda: gemm(a, b, tile=tile), reps)
        plain_ms = time_ms(lambda: ref.gemm_ref(a, b), reps)
        library_ms = time_ms(lambda: torch.matmul(a, b), reps)
        bound_ms, bound_by = bound(a.element_size() * (m * k + k * n + m * n),
                                   2.0 * m * n * k, dtype)
        row = {"phase": "gemm", "m": m, "n": n, "k": k,
               "dtype": str(dtype).removeprefix("torch."),
               "block": list(c["cfg"].block), "tile": list(tile),
               "grid": list(c["cfg"].grid),
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "max_abs_err": err, "rtol": rtol,
               "atol": atol, "ok": ok}
        emit(row)
        k1.append({"ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound": (bound_ms, bound_by),
                   "err": err})
        if not ok:
            failures.append(f"gemm {m}x{n}x{k} {dtype}: max err {err}")

    k3, k4 = [], []
    for c in gru_cases:
        (batch, hidden), xs, h0 = c["bh"], c["xs"], c["h0"]
        inp = hidden
        params = c["model"].params()
        block, _ = plan_gru(batch, hidden, inp, graph=graph)
        tile = gru_tile(block)
        want = ref.gru_seq_ref(xs, h0, params)
        err, ok = mismatch(c["out"], want, *GRU_TOL)
        if not ok:
            failures.append(f"gru {batch}x{hidden}: max err {err}")
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
            x0, out = xs[0], torch.empty_like(h0)
            step_err, step_ok = mismatch(
                gru_cell(x0, h0, params, tile=tile, out=out),
                ref.gru_cell_ref(x0, h0, params), *CELL_TOL)
            if not step_ok:
                failures.append(f"gru_cell {batch}x{hidden}: max err "
                                f"{step_err}")
            step_ms = time_ms(
                lambda: gru_cell(x0, h0, params, tile=tile, out=out), 50)
            step_plain_ms = time_ms(
                lambda: ref.gru_cell_ref(x0, h0, params), 50)
            step_lib_ms = time_ms(
                lambda: torch.gru_cell(x0, h0, w_ih, w_hh, b_ih, b_hh), 50)
            seq_ms = time_ms(lambda: gru_seq(xs, h0, params, tile=tile), 5)
            seq_plain_ms = time_ms(lambda: ref.gru_seq_ref(xs, h0, params), 5)
            seq_lib_ms = time_ms(lambda: lib_gru(xs, h0[None]), 5)
        w_bytes = 4 * (3 * inp * hidden + 3 * hidden * hidden + 4 * hidden)
        step_flops = 2.0 * batch * hidden * 3 * (inp + hidden)
        step_bound = bound(w_bytes + 4 * batch * (inp + 2 * hidden),
                           step_flops, torch.float32)
        seq_bound = bound(w_bytes + 4 * (STEPS * batch * inp + 2 * batch * hidden),
                          STEPS * step_flops, torch.float32)
        row = {"phase": "gru", "batch": batch, "hidden": hidden, "inp": inp,
               "steps": STEPS, "block": list(block), "tile": list(tile),
               "step_ms": step_ms, "step_plain_ms": step_plain_ms,
               "step_library_ms": step_lib_ms, "step_bound_ms": step_bound[0],
               "step_bound_by": step_bound[1],
               "seq_ms": seq_ms, "seq_plain_ms": seq_plain_ms,
               "seq_library_ms": seq_lib_ms, "seq_bound_ms": seq_bound[0],
               "seq_bound_by": seq_bound[1],
               "steps_x_step_bound_ms": STEPS * step_bound[0],
               "step_max_abs_err": step_err, "max_abs_err": err,
               "library_max_abs_err": lib_err, "rtol": GRU_TOL[0],
               "atol": GRU_TOL[1], "ok": ok and step_ok}
        emit(row)
        k3.append({"ms": step_ms, "plain_ms": step_plain_ms,
                   "library_ms": step_lib_ms, "bound": step_bound,
                   "err": step_err})
        k4.append({"ms": seq_ms, "plain_ms": seq_plain_ms,
                   "library_ms": seq_lib_ms, "bound": seq_bound, "err": err})

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
                "library_ms": sum(r["library_ms"] for r in rs)}

    kernels = [
        entry("gemm", "src/repro_torch/csrc/gemm.cu",
              "src/repro/kernels/gemm.py:103", launches["gemm"], k1),
        entry("gru_cell", "src/repro_torch/csrc/gru.cu",
              "src/repro/kernels/gru.py:83", launches["gru_cell"], k3),
        entry("gru_seq", "src/repro_torch/kernels/gru.py",
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
