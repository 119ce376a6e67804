"""The benchmark's command: no result without a card or without the program,
and, on the card, one short run of every cell that is correct."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from _cells import CELLS

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd: Path, cell: str, seconds: str = "1", trace: str = "0",
         env=None) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "3000000001", "--seconds", seconds, "--trace", trace],
        cwd=cwd, capture_output=True, text=True, timeout=900, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _run(ROOT, "gemm-bf16-call", env=env)
    assert res.returncode != 0 and res.stdout == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path, "gemm-bf16-call")
    assert res.returncode != 0 and res.stdout == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_card(card, cell, trace):
    res = _run(ROOT, cell, trace=trace)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "checks"
    if trace == "1":
        assert out["device"]["busy_s"] > 0
        assert out["breakdown"]["device_ops"]
