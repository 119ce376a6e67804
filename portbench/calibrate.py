"""The readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 3

For each program seed, one run of the cell as the benchmark makes it, with a
short window: the numbers compared, from sound runs of the program.  For
each control seed, the same run with the control in the program's place:
the reference with its operands one precision below the configuration's
(TF32 for f32, fp8 e4m3 for bf16).  All in one process, one JSON line a
run, then a summary line: the largest program reading and the smallest
control reading of each number.  The benchmark's own runs never run the
control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        q for q in sys.path if Path(q or ".").resolve() != here]
    import torch
    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_benchmark(ROOT)
    cell = harness.load_cell(bench, args.workload, ROOT)
    dev = torch.device("cuda", 0)
    readings = {"program": {}, "control": {}}
    for side, side_seeds in (("program", args.seeds),
                             ("control", args.control_seeds)):
        for seed in side_seeds:
            out = harness.run_cell(cell, seed, args.seconds, False, dev,
                                   time.perf_counter(),
                                   control=side == "control")
            nums = {k: c["value"] for k, c in out["checks"].items()}
            for k, v in nums.items():
                readings[side].setdefault(k, []).append(v)
            print(json.dumps({"workload": args.workload, "side": side,
                              "seed": seed, "numbers": nums,
                              "attempted": out["attempted"],
                              "failed": out["failed"],
                              "metrics": out["metrics"]}), flush=True)
    summary = {"workload": args.workload,
               "program_max": {k: max(v) for k, v in readings["program"].items()},
               "control_min": {k: min(v) for k, v in readings["control"].items()},
               "seconds": time.perf_counter() - T_START}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
