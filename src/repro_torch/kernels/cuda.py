"""The card: device resolution, and the build and binding of the CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
library is built at first use into ``build/repro_torch/`` at the repository
root, under a file name keyed on a hash of its source, the headers it
includes and the compiler flags, so a changed source or header is rebuilt
and an unchanged one is reused.
``build_kernels`` starts one ``nvcc`` per source, all at once.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gemm", "gru")
#: the largest shared memory one block can use on Hopper
MAX_SMEM_BYTES = 232_448
#: cudaErrorCooperativeLaunchTooLarge: a grid that cannot be co-resident
COOPERATIVE_TOO_LARGE = 720
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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every file it includes with quotes, directly
    or through another such file, in the order first reached."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: keyed on the
    source, every header it includes (``source_files``) and the flags."""
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
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


def ptxas_report(name: str) -> dict[str, dict[str, int]]:
    """What ``-Xptxas -v`` said of each kernel of the library built from
    ``csrc/<name>.cu``: mangled name -> registers (a count) and stack,
    spill_stores, spill_loads (bytes).  Empty before the first build."""
    log = library_path(name).with_suffix(".log")
    return parse_ptxas(log.read_text()) if log.exists() else {}


def parse_ptxas(text: str) -> dict[str, dict[str, int]]:
    """Parse the ``-Xptxas -v`` report of one build (see ``ptxas_report``)."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            cur = out.setdefault(m.group(1), {})
        elif cur is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m.group(1))
    return out


def check(status: int, kernel: str) -> None:
    """Raise unless a C entry point returned 0 (``cudaSuccess``)."""
    if status == -1:
        raise ValueError(f"{kernel}: the library has no kernel for these "
                         "arguments (tile, dtype or launch)")
    if status == -2:
        raise RuntimeError(f"{kernel}: cuTensorMapEncodeTiled refused a TMA "
                           "descriptor")
    if status == COOPERATIVE_TOO_LARGE:
        raise RuntimeError(f"{kernel}: the grid cannot be co-resident on the "
                           f"card (CUDA error {status})")
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA error {status} at launch")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` (a tensor's device, with its
    index) as an integer handle, read without building a ``Stream``
    object: K1's small shapes take less device time than one call's host
    path."""
    return torch._C._cuda_getCurrentRawStream(device.index)
