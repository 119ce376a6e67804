"""``python -m repro_torch.serve`` / ``repro-torch servesim`` — the serving
simulator.

    repro-torch servesim                              # 32 reqs, online fifo
    repro-torch servesim --requests 64 --rate 400 --seed 1  # heavier load
    repro-torch servesim --arrival burst --burst 8    # flash-crowd arrivals
    repro-torch servesim --archs olmo-1b,qwen2-7b     # two model families
    repro-torch servesim --scheduler static           # one-shot baseline
    repro-torch servesim --scheduler frozen           # freeze online-fifo,
                                                      #   replay the trace
    repro-torch servesim --compare                    # online vs static,
                                                      #   goodput both ways
    repro-torch servesim --cache arts.json            # warm through a cache
    repro-torch servesim --cache arts.json --expect-cached  # 2nd run: 0 fresh
    repro-torch servesim --tuning-model models.json   # learned K1 blocks
    repro-torch servesim --verify --json report.json

Runs on the host alone: the latencies, makespans and goodput it prints are
modelled, from the compiled blocks' simulated makespans on ``gpu_sm(8)``.

Exit status: 0 iff the run completes every request, ``--verify`` finds no
``srv.*`` errors, ``--expect-cached`` sees zero fresh compiles, and (with
``--compare``) online goodput is at least static's.
"""
from __future__ import annotations

import argparse
import json


def _build_scheduler(name: str):
    from .scheduler import (FifoOnlineScheduler, StaticBatchScheduler,
                            make_static_scheduler)
    if name == "online":
        return FifoOnlineScheduler()
    if name == "static":
        return StaticBatchScheduler()
    if name == "frozen":
        return make_static_scheduler(FifoOnlineScheduler)()
    raise ValueError(f"unknown scheduler {name!r}")


def _print_metrics(label: str, m: dict) -> None:
    print(f"{label:<14} completed={m['completed']}/{m['n_requests']} "
          f"iters={m['iterations']} makespan={m['makespan_s']:.3e}s "
          f"p50={m['p50_latency_s']:.3e}s p99={m['p99_latency_s']:.3e}s "
          f"goodput={m['goodput_tps']:.1f} tok/s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch servesim",
        description="Online continuous-batching serving simulation: seeded "
                    "request traffic against the warmed (arch x bucket) "
                    "lattice of compiled block graphs.")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="mean arrival rate, requests/second (default 200)")
    ap.add_argument("--arrival", choices=("poisson", "burst"),
                    default="poisson")
    ap.add_argument("--burst", type=int, default=4,
                    help="burst size for --arrival burst (default 4)")
    ap.add_argument("--archs", default="olmo-1b",
                    help="comma list of model families (default olmo-1b)")
    ap.add_argument("--buckets", default=None,
                    help="comma list of seq-len buckets (default 4,8,16)")
    ap.add_argument("--scheduler", choices=("online", "static", "frozen"),
                    default="online")
    ap.add_argument("--compare", action="store_true",
                    help="run online AND static on the same workload; fail "
                         "if online goodput < static")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--kv-budget", type=int, default=1 << 20,
                    help="KV-cache byte budget (default 1 MiB)")
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help="artifact cache for the bucket-lattice warmup")
    ap.add_argument("--expect-cached", action="store_true",
                    help="fail unless warmup performs zero fresh compiles")
    ap.add_argument("--tuning-model", default=None, metavar="PATH",
                    help="learned cost-model store: predict blocks for "
                         "never-tuned shapes")
    ap.add_argument("--verify", action="store_true",
                    help="run the srv.* trace verifier on the result")
    ap.add_argument("--json", default=None, help="write the report here")
    args = ap.parse_args(argv)

    from ..compile.cache import ArtifactCache
    from .bucket import DEFAULT_BUCKETS, ServingPool
    from .simulate import ServeParams, simulate_serving
    from .workload import generate_requests

    if args.tuning_model:
        from ..search.model import ModelStore, set_default_store
        set_default_store(ModelStore(args.tuning_model))

    archs = tuple(a.strip() for a in args.archs.split(",") if a.strip())
    buckets = DEFAULT_BUCKETS if args.buckets is None else \
        tuple(int(b) for b in args.buckets.split(","))
    cache = ArtifactCache(args.cache) if args.cache else None
    pool = ServingPool(archs=archs, buckets=buckets, cache=cache)
    warm = pool.warmup()
    print(f"warmup   {warm['entries']} bucket artifact(s) "
          f"({warm['archs']} arch x {warm['buckets']} bucket): "
          f"{warm['nodes']} nodes -> {warm['unique_programs']} unique "
          f"program(s), fresh={warm['fresh_compiles']} "
          f"cached={warm['cache_hits']} evicted={warm['evicted']}")

    failures = 0
    if args.expect_cached and warm["fresh_compiles"]:
        print(f"[FAIL] --expect-cached: {warm['fresh_compiles']} fresh "
              "compile(s) during warmup")
        failures += 1

    from .workload import DEFAULT_PROMPT_LENS
    prompt_lens = tuple(p for p in DEFAULT_PROMPT_LENS
                        if p <= max(buckets)) or (max(buckets),)
    requests = generate_requests(
        args.requests, seed=args.seed, rate=args.rate,
        arrival=args.arrival, burst_size=args.burst, archs=archs,
        prompt_lens=prompt_lens)
    params = ServeParams(max_batch=args.max_batch,
                         kv_budget=args.kv_budget)

    runs = {}
    names = ("online", "static") if args.compare else (args.scheduler,)
    for name in names:
        res = simulate_serving(requests, pool, _build_scheduler(name),
                               params)
        runs[name] = res
        _print_metrics(name, res.metrics)
        if res.metrics["starved"]:
            print(f"[FAIL] {name}: {res.metrics['starved']} request(s) "
                  "starved")
            failures += 1

    if args.compare:
        on, st = runs["online"].metrics, runs["static"].metrics
        ok = on["goodput_tps"] >= st["goodput_tps"]
        print(f"{'[ok]' if ok else '[FAIL]'} online goodput "
              f"{on['goodput_tps']:.1f} vs static {st['goodput_tps']:.1f} "
              "tok/s")
        failures += not ok

    if args.verify:
        from ..verify.serve import verify_serve_trace
        for name, res in runs.items():
            diags = verify_serve_trace(res.trace())
            errs = [d for d in diags if d.severity == "error"]
            print(f"{'[ok]' if not errs else '[FAIL]'} verify {name}: "
                  f"{len(errs)} error(s)")
            for d in errs:
                print(f"    {d}")
            failures += len(errs)

    if args.json:
        payload = {"schema": 1, "warmup": warm,
                   "runs": {name: res.trace() for name, res in runs.items()},
                   "failures": failures}
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"# report: {args.json}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
