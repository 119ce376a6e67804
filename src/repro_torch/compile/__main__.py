"""Compilation-driver CLI (``repro-torch compile``).

    PYTHONPATH=src python -m repro_torch.compile --kernel gemm \\
        --shape 1024x1024x1024
    PYTHONPATH=src python -m repro_torch.compile --suite smoke --validate \\
        --cache build/compile_cache.json --json build/compile.json

Compiles workloads through the full pipeline (Map → Select → Schedule →
Lower) and prints one ``CompiledKernel`` summary per case: the role-derived
tile, the lowering config, the modeled cost, and whether the artifact came
from the persistent cache.  ``--validate`` replays each schedule through
``core.executor`` against the ``ir.interpret`` oracle on a proxy-capped
shape and requires bit-exactness.  ``--expect-cached`` fails unless every
case hit the cache (it proves artifact reuse).  The default target is the
port's, ``gpu_sm`` (``--target tpu_v5e`` compiles against the JAX package's
modelled TPU instead).

Multi-chip: ``--chips N --topology ring|torus|host`` compiles the fabric
partition + collective plan instead of a single-chip schedule (on the
``tpu_v5e`` target only, as in the JAX package).

Exit status: 0 iff every case compiled (and validated / hit the cache when
asked).
"""
from __future__ import annotations

import argparse
import json
import sys

from ..core.sysgraph import TARGET_ALIASES, TARGETS, resolve_target
from .artifact import CompileError
from .cache import ArtifactCache, set_default_artifact_cache
from .driver import (compile_conv, compile_fabric, compile_gemm, compile_gru,
                     resolve_approach)

#: Oracle proxies cap each axis (same policy as the tuner and the fabric tier).
VALIDATE_DIM_CAP = 192

SMOKE_CASES = [
    ("gemm", {"m": 512, "n": 256, "k": 1024}),
    ("gru", {"batch": 16, "hidden": 64}),
    ("conv", {"batch": 2, "h": 6, "w": 6, "kh": 1, "kw": 1,
              "cin": 8, "cout": 8}),
]


#: Default --shape per kernel (conv extents come from --conv-args).
DEFAULT_SHAPES = {"gemm": "1024x1024x1024", "gru": "32x512"}


def _parse_shape(text: str, kernel: str) -> dict:
    """Shape dict for one kernel; raises ``ValueError`` on malformed input
    (main() turns it into an argparse usage error)."""
    dims = [int(x) for x in text.lower().split("x")]
    if kernel == "gemm":
        if len(dims) != 3:
            raise ValueError("gemm shape is MxNxK")
        return {"m": dims[0], "n": dims[1], "k": dims[2]}
    if len(dims) != 2:
        raise ValueError("gru shape is BATCHxHIDDEN")
    return {"batch": dims[0], "hidden": dims[1]}


def _compile_case(kernel: str, kw: dict, approach, args, graph):
    if args.chips > 1:
        from ..fabric.topology import make_topology
        topo = make_topology(args.topology, args.chips)
        if kernel == "gemm":
            shape = (kw["m"], kw["n"], kw["k"])
        elif kernel == "gru":
            shape = (kw["batch"], kw["hidden"])
        else:
            raise CompileError("multi-chip compile supports gemm/gru")
        return compile_fabric(kernel, shape, topo, axis=args.axis,
                              approach=approach)
    fn = {"gemm": compile_gemm, "gru": compile_gru,
          "conv": compile_conv}[kernel]
    return fn(approach=approach, graph=graph, verify=not args.no_verify,
              **kw)


def _proxy_args(kernel: str, kw: dict) -> dict:
    cap = VALIDATE_DIM_CAP
    if kernel == "gemm":
        return {k: min(v, cap) for k, v in kw.items()}
    if kernel == "gru":
        return {"batch": min(kw["batch"], 4), "hidden": min(kw["hidden"], 16)}
    return dict(kw, batch=min(kw["batch"], 2), h=min(kw["h"], 6),
                w=min(kw["w"], 6), cin=min(kw["cin"], 8),
                cout=min(kw["cout"], 8))


def _validate(kernel: str, kw: dict, approach, graph):
    """Bit-exact executor-vs-oracle replay of a proxy-sized compile on the
    same target graph the full-size artifact was compiled for."""
    from ..search.evaluate import validate_schedule
    from .driver import _FRONTENDS, compile_selection
    pkw = _proxy_args(kernel, kw)
    orig, sel = _FRONTENDS[kernel](**pkw)
    art = compile_selection(sel, graph, approach, program=orig)
    return validate_schedule(orig, sel, art.ensure_schedule())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.compile",
        description="Pass-based compilation driver: compile a workload to a "
                    "CompiledKernel artifact (tile plan, lowering config, "
                    "modeled cost) and exercise the artifact cache.")
    ap.add_argument("--kernel", choices=["gemm", "gru", "conv"],
                    default="gemm")
    ap.add_argument("--shape", default=None,
                    help="MxNxK (gemm) or BATCHxHIDDEN (gru); default "
                         f"{DEFAULT_SHAPES}")
    ap.add_argument("--conv-args", default="4,14,14,3,3,32,64",
                    metavar="B,H,W,KH,KW,CIN,COUT",
                    help="conv2d extents (kernel=conv)")
    ap.add_argument("--suite", choices=["smoke"], default=None,
                    help="compile a fixed case list instead of one kernel")
    ap.add_argument("--approach", choices=["greedy", "costmodel"],
                    default="greedy")
    ap.add_argument("--target",
                    choices=sorted(set(TARGETS) | set(TARGET_ALIASES)),
                    default="gpu_sm",
                    help="modeled hardware target (core.sysgraph factory); "
                         "single-chip compiles and --validate replays run "
                         "against this graph")
    ap.add_argument("--chips", type=int, default=1,
                    help=">1 compiles the fabric partition for the topology")
    ap.add_argument("--topology", choices=["ring", "torus", "host"],
                    default="ring")
    ap.add_argument("--axis", default=None,
                    help="fabric partition axis (default: the kernel's first)")
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help="persistent artifact cache (activated process-wide)")
    ap.add_argument("--no-cache", action="store_true",
                    help="compile fresh, ignoring any cache")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the static verifier pass (escape hatch)")
    ap.add_argument("--validate", action="store_true",
                    help="bit-exact oracle replay on a proxy-capped shape")
    ap.add_argument("--expect-cached", action="store_true",
                    help="fail unless every artifact came from the cache")
    ap.add_argument("--json", default=None, help="write the report here")
    args = ap.parse_args(argv)

    if args.cache and not args.no_cache:
        set_default_artifact_cache(ArtifactCache(args.cache))
    approach = resolve_approach(args.approach)
    graph = resolve_target(args.target)
    if args.chips > 1 and graph.family != "tpu":
        ap.error("--chips > 1 (fabric compile) currently supports the "
                 "tpu_v5e target only")

    if args.suite == "smoke":
        cases = SMOKE_CASES
    else:
        try:
            if args.kernel == "conv":
                b, h, w, kh, kw_, cin, cout = (
                    int(x) for x in args.conv_args.split(","))
                kw = {"batch": b, "h": h, "w": w, "kh": kh, "kw": kw_,
                      "cin": cin, "cout": cout}
            else:
                shape = args.shape or DEFAULT_SHAPES[args.kernel]
                kw = _parse_shape(shape, args.kernel)
        except ValueError as e:
            ap.error(str(e))
        cases = [(args.kernel, kw)]

    rows = []
    failures = 0
    for kernel, kw in cases:
        try:
            art = _compile_case(kernel, kw, approach, args, graph)
        except CompileError as e:
            print(f"[FAIL] {kernel} {kw}: {e}", file=sys.stderr)
            failures += 1
            continue
        row = {"kernel": kernel, "args": kw, "program": art.program_name,
               "graph": art.graph_name, "cost_s": art.cost,
               "lowering": art.lowering, "cached": art.from_cache,
               "counts": art.counts, "bytes_moved": art.bytes_moved,
               "key": art.key}
        try:
            row["tile"] = list(art.gemm_tile())
        except CompileError:
            row["tile"] = None
        if art.fabric:
            row["fabric"] = {k: art.fabric[k]
                             for k in ("axis", "algorithm", "chips",
                                       "topology", "makespan")}
        status = "ok"
        if args.expect_cached and not art.from_cache:
            status = "MISS"
            failures += 1
        if args.validate and args.chips == 1:
            rep = _validate(kernel, kw, approach, graph)
            row["oracle_exact"] = rep.exact
            if not rep.exact:
                status = "MISMATCH"
                failures += 1
        rows.append(row)
        print(f"[{status}] {art.summary()}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"schema": 1, "approach": args.approach,
                       "target": args.target, "failures": failures,
                       "rows": rows}, f, indent=2)
        print(f"# report: {args.json}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
