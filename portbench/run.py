"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result (JSON); the numbers compared
with the plain reference, each beside its limit, are the last lines of
standard error.  Without a card, or with fewer cards than the cell asks
for, or without the program beside the benchmark (``src/repro_torch``), it
exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402

# one client thread drives the card: no host thread pools beside it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: no program at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        q for q in sys.path if Path(q or ".").resolve() != here]
    import torch
    from portbench import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.load_cell(bench, args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    banned = harness.loaded_banned()
    if banned:
        print(f"portbench: the run loaded {banned}", file=sys.stderr)
        return 3
    for err in out.pop("errors"):
        print(f"portbench: request failed: {err}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
