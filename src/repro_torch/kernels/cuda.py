"""The card: device resolution, and the build and binding of the CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
library is built at first use into ``build/repro_torch/`` at the repository
root, under a file name keyed on a hash of its source and the compiler
flags, so a changed source is rebuilt and an unchanged one is reused.
``build_kernels`` starts one ``nvcc`` per source, all at once.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gemm", "gru")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  ``None`` means ``"cuda"``, which raises when no card is
    present — the port never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the plain "
            "PyTorch versions")
    return dev


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_kernels(names=SOURCES) -> dict[str, Path]:
    """Build every library in ``names`` that is not built yet, one ``nvcc``
    process per source, all started together; wait for all of them and
    raise if any failed.  The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    paths = {name: library_path(name) for name in names}
    todo = [name for name, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for name in todo:
            out = paths[name]
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = open(out.with_suffix(".log"), "w")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, tmp, log,
                          subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT)))
    finally:
        failed = []
        for name, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, paths[name])
            else:
                failed.append(name)
    if failed:
        tails = {n: paths[n].with_suffix(".log").read_text()[-4000:]
                 for n in failed}
        raise RuntimeError(f"nvcc failed for {failed}: {tails}")
    return paths


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    return ctypes.CDLL(str(build_kernels((name,))[name]))


def check(status: int, kernel: str) -> None:
    """Raise unless a C entry point returned 0 (``cudaSuccess``)."""
    if status == -1:
        raise ValueError(f"{kernel}: the library has no such tile or dtype")
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA error {status} at launch")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
