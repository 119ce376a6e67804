"""What the CPU tests share: the benchmark as committed, and its cells cut
to sizes that a test run on the CPU can hold."""
from __future__ import annotations

import time

import torch

from portbench import harness

#: each configuration's shapes cut for the CPU (the card runs them whole)
SMALL = {"deepbench-gemm": {"shapes": [[64, 32, 48], [35, 16, 40],
                                       [96, 1, 64]]},
         "deepbench-gru": {"sizes": [[4, 32], [2, 48]], "steps": 6}}
CELLS = ("gemm-f32-pass", "gru-seq-bf16", "gemm-bf16-call", "gru-stream-bf16")


def small_cell(name: str) -> harness.Cell:
    bench = harness.load_benchmark()
    cell = harness.load_cell(bench, name)
    config = harness.find(bench["workloads"], name, "workload")["config"]
    cell.config.update(SMALL[config])
    return cell


def run_small(name: str, seed: int = 2**31 + 7, control: bool = False,
              trace: bool = False, seconds: float = 0.3) -> dict:
    """One run of the cell on the CPU at the small sizes, past the look for
    a card; the program's CPU path is its plain versions."""
    return harness.run_cell(small_cell(name), seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter(),
                            control=control)
