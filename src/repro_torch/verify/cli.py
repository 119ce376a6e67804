"""``repro-torch verify`` — run the static analyzer over the tune suites.

    repro-torch verify                    # gemm+gru+conv+fabric+graph+serve
    repro-torch verify --suite gemm,conv  # subset
    repro-torch verify --tuned            # also check tuned configs (cache)
    repro-torch verify --mutate           # prove the rules fire (harness)
    repro-torch verify --json report.json

(``python -m repro_torch.verify`` runs the same ``main``.)

Every case compiles fresh (Schedule only — the verifier is the subject
here, so it runs *after* the pipeline, not inside it) against the port's
target, ``gpu_sm(8)`` (``search.tune.make_graph``; the graph cases' first
placement budget is half its fastest memory, as ``compile_graph``'s
default), and the report lists each diagnostic with its rule id.  Exit
status: 0 iff every compile verifies clean and — with ``--mutate`` — every
corruption class is caught.
"""
from __future__ import annotations

import argparse
import json

SUITES = ("gemm", "gru", "conv", "fabric", "graph", "serve")

#: the ``search.tune.make_graph`` name every compile of the sweep runs on
TARGET = "gpu_sm"


def _verify_suite_cases(suite: str, limit, tuned: bool, rows: list) -> int:
    from ..compile.driver import compile_selection
    from ..search.tune import build_cases, make_graph
    from . import verify_compile
    failures = 0
    graph = make_graph(TARGET)
    for case in build_cases(suite, limit):
        for label, approach in _approaches(case, graph, tuned):
            art = compile_selection(case.selection, graph, approach,
                                    program=case.program)
            report = verify_compile(selection=case.selection,
                                    schedule=art.schedule,
                                    approach=art.approach)
            failures += _emit(f"{case.name}[{label}]", report, rows)
    return failures


def _approaches(case, graph, tuned: bool):
    """(label, approach) pairs for one case: greedy, plus the tuned config
    when a cache record exists."""
    yield "greedy", None
    if not tuned:
        return
    from ..search.cache import get_default_cache
    from ..search.space import ParamApproach, tuning_key
    cache = get_default_cache()
    rec = cache.lookup(tuning_key(case.program, graph, "cost"))
    if rec is not None and getattr(rec, "config", None):
        yield "tuned", ParamApproach(rec.config)


def _verify_fabric_cases(limit, rows: list) -> int:
    from ..fabric.partition import partition, partition_axes
    from ..fabric.topology import make_topology
    from . import DiagnosticReport, verify_fabric
    from ..search.tune import FABRIC_GEMM_SIZES
    failures = 0
    topo = make_topology("ring", 4)
    shapes = FABRIC_GEMM_SIZES[:limit] if limit else FABRIC_GEMM_SIZES
    for shape in shapes:
        for axis in partition_axes("gemm"):
            pp = partition("gemm", shape, axis, topo.n_chips)
            report = DiagnosticReport()
            report.extend(verify_fabric(pp, topo))
            name = "fabric_gemm_{}_{}".format("x".join(map(str, shape)), axis)
            failures += _emit(name, report, rows)
    return failures


def _verify_graph_cases(limit, rows: list) -> int:
    """The graph layer: traced kernel graphs (fused and unfused) plus their
    placement plans must verify clean under the ``gra.*`` rules."""
    from ..configs.registry import get_trace_config
    from ..graph.compile import RESIDENCY_FRAC, plan_placement
    from ..graph.fuse import fuse_epilogues
    from ..graph.trace import trace_block, trace_gru_chain
    from ..search.tune import make_graph
    from . import DiagnosticReport, verify_graph, verify_placement
    failures = 0
    cases = [("block_unfused",
              lambda: trace_block(get_trace_config("olmo-1b"), seq_len=8)),
             ("block_fused",
              lambda: fuse_epilogues(
                  trace_block(get_trace_config("olmo-1b"), seq_len=8))[0]),
             ("gru_chain", trace_gru_chain)]
    fastest = max(make_graph(TARGET).memories.values(),
                  key=lambda m: m.level)
    budgets = (int(fastest.capacity * RESIDENCY_FRAC), 4096)
    for name, build in cases[:limit] if limit else cases:
        g = build()
        report = DiagnosticReport()
        report.extend(verify_graph(g))
        for budget in budgets:
            pl = plan_placement(g, budget)
            report.extend(verify_placement(g, pl.locations, budget))
        failures += _emit(f"graph_{name}", report, rows)
    return failures


def _verify_serve_cases(limit, rows: list) -> int:
    """The serving layer: seeded online and static runs must produce
    ``srv.*``-clean traces, and the frozen replay of the online policy
    must agree with the live run to the bit."""
    from ..serve.bucket import ServingPool
    from ..serve.scheduler import (FifoOnlineScheduler, StaticBatchScheduler,
                                   make_static_scheduler)
    from ..serve.simulate import ServeParams, simulate_serving
    from ..serve.workload import generate_requests
    from . import DiagnosticReport, verify_replay, verify_serve_trace
    failures = 0
    pool = ServingPool(archs=("olmo-1b",), buckets=(4, 8), use_cache=False)
    pool.warmup()
    reqs = generate_requests(12, seed=0, rate=400.0,
                             prompt_lens=(2, 4, 6, 8), decode_lens=(1, 2, 3))
    params = ServeParams(max_batch=4, kv_budget=1 << 15)
    cases = [("online", FifoOnlineScheduler()),
             ("static", StaticBatchScheduler())]
    results = {}
    for name, sched in cases[:limit] if limit else cases:
        res = simulate_serving(reqs, pool, sched, params)
        results[name] = res
        report = DiagnosticReport()
        report.extend(verify_serve_trace(res.trace()))
        failures += _emit(f"serve_{name}", report, rows)
    if "online" in results:
        frozen = simulate_serving(
            reqs, pool, make_static_scheduler(FifoOnlineScheduler)(), params)
        report = DiagnosticReport()
        report.extend(verify_serve_trace(frozen.trace()))
        report.extend(verify_replay(frozen.trace(),
                                    results["online"].trace()))
        failures += _emit("serve_frozen_replay", report, rows)
    return failures


def _emit(name: str, report, rows: list) -> int:
    rows.append({"case": name, **report.to_dict()})
    status = "ok" if report.ok else "FAIL"
    extra = f", {len(report.warnings)} warning(s)" if report.warnings else ""
    print(f"[{status}] {name}: {len(report.errors)} error(s){extra}")
    for d in report.diagnostics:
        print(f"    {d}")
    return 0 if report.ok else 1


def _run_mutations(rows: list) -> int:
    from .mutate import baseline_report, run_all
    base = baseline_report()
    failures = _emit("mutate-baseline", base, rows)
    missed = total = 0
    for res in run_all():
        print(f"  {res}")
        rows.append({"mutation": res.name, "expected": res.expected,
                     "caught": res.caught, "rules": sorted(set(res.rules))})
        missed += not res.caught
        total += 1
    if missed:
        print(f"[FAIL] mutation harness: {missed} class(es) NOT caught")
    else:
        print(f"[ok] mutation harness: all {total} classes caught")
    return failures + missed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch verify",
        description="Static analyzer sweep: verify every tune-suite compile "
                    "(program/selection/schedule/fabric layers) and "
                    "optionally prove the rules fire via the mutation "
                    "harness.")
    ap.add_argument("--suite", default="all",
                    help=f"comma list from {SUITES} or 'all'")
    ap.add_argument("--limit", type=int, default=None,
                    help="cap the number of cases per suite")
    ap.add_argument("--tuned", action="store_true",
                    help="also verify tuned configs from the tuning cache")
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help="tuning cache for --tuned (default: the standard "
                         "cache location)")
    ap.add_argument("--mutate", action="store_true",
                    help="run the mutation harness as well")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--json", default=None, help="write the report here")
    args = ap.parse_args(argv)

    if args.rules:
        from .diagnostics import RULES
        for rule, desc in RULES.items():
            print(f"{rule:<22} {desc}")
        return 0

    suites = SUITES if args.suite == "all" else \
        tuple(s.strip() for s in args.suite.split(","))
    bad = [s for s in suites if s not in SUITES]
    if bad:
        ap.error(f"unknown suite(s) {bad}; pick from {SUITES}")

    if args.cache:
        from ..search.cache import TuningCache, set_default_cache
        set_default_cache(TuningCache(args.cache))

    rows: list = []
    failures = 0
    for suite in suites:
        if suite == "fabric":
            failures += _verify_fabric_cases(args.limit, rows)
        elif suite == "graph":
            failures += _verify_graph_cases(args.limit, rows)
        elif suite == "serve":
            failures += _verify_serve_cases(args.limit, rows)
        else:
            failures += _verify_suite_cases(suite, args.limit, args.tuned,
                                            rows)
    if args.mutate:
        failures += _run_mutations(rows)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"schema": 1, "failures": failures, "rows": rows},
                      f, indent=2)
        print(f"# report: {args.json}")
    print(f"# {len(rows)} check(s), {failures} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
