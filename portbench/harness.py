"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

Everything particular to a cell is found by name.  ``BENCHMARK.json`` names
the cell's configuration (its file) and traffic mix; the traffic file
(``traffic/<name>.json``) names the program entry (``entries/<entry>.py``)
and holds the mix's parameters and the limits of the numbers compared; each
metric is a reader in ``metrics/<name>.py``.  Adding a cell, a configuration,
a traffic mix or a metric adds a file and an entry, and edits none here.

The load is a closed loop with one client: a request is issued, waited for
(``torch.cuda.synchronize``), and the next one follows.  Requests come in
rounds; each round holds every request class of the configuration once, in
an order and on input slots drawn from the seed, so every seed runs the
same work in another order.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import tempfile
import time
from array import array
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: host seconds of the profiler's slice in a traced run
TRACE_SECONDS = 1.0
#: rounds of every request class run before the window opens
WARM_ROUNDS = 2
#: top-level module names that may not be loaded in a run's process
BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise LookupError(f"no {what} named {name!r}: have "
                      f"{[e['name'] for e in entries]}")


def load_json(folder: str, name: str) -> dict:
    path = HERE / folder / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"no {folder} file {path.name} under {HERE}")
    with open(path) as f:
        return json.load(f)


def load_code(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {folder} module {path.name} under {HERE}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    with open(root / find(bench["configs"], name, "config")["file"]) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it, and those without a list that
    move an end-to-end metric the cell reports (an end-to-end metric
    without a list is reported everywhere)."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    out = []
    for m in bench[kind]:
        listed = m.get("workloads")
        if listed is not None:
            if cell in listed:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


class Requests:
    """The general generator: rounds of every request class once, in an
    order drawn from the seed, each on an input slot drawn from the seed."""

    def __init__(self, n_classes: int, pool: int, seed: int):
        self.rng = np.random.default_rng(seed)
        self.n, self.pool = n_classes, pool
        self.queue: list = []

    def __next__(self) -> tuple[int, int]:
        if not self.queue:
            order = self.rng.permutation(self.n)
            slots = self.rng.integers(self.pool, size=self.n)
            self.queue = [(int(c), int(s)) for c, s in zip(order, slots)][::-1]
        return self.queue.pop()


class Sample:
    """A uniform sample, drawn from the seed, of each class's requests and
    what they returned: ``per_class`` kept a class (reservoir sampling)."""

    def __init__(self, n_classes: int, per_class: int, seed: int):
        self.rng = random.Random(f"sample-{seed}")
        self.per_class = per_class
        self.seen = [0] * n_classes
        self.kept: list[list] = [[] for _ in range(n_classes)]

    def offer(self, req, out) -> None:
        cls = req[0]
        self.seen[cls] += 1
        kept = self.kept[cls]
        if len(kept) < self.per_class:
            kept.append((req, out))
        else:
            j = self.rng.randrange(self.seen[cls])
            if j < self.per_class:
                kept[j] = (req, out)

    def items(self) -> list:
        return [item for kept in self.kept for item in kept]


@dataclass
class Window:
    """What a stretch of the closed loop did: each completed request (class
    and slot) and its latency (host clock, from the call to its
    synchronize), and the length.  Kept in flat arrays, which the garbage
    collector does not walk, so the record adds no collection time to the
    requests it records."""

    classes: array = field(default_factory=lambda: array("i"))
    slots: array = field(default_factory=lambda: array("i"))
    latencies: array = field(default_factory=lambda: array("d"))
    seconds: float = 0.0
    attempted: int = 0
    failed: int = 0
    errors: list = field(default_factory=list)

    @property
    def reqs(self):
        return zip(self.classes, self.slots)

    @property
    def completed(self) -> int:
        return len(self.latencies)


def drive(call, sync, requests: Requests, sample: Sample,
          seconds: float) -> Window:
    """Issue requests until ``seconds`` have passed; the window ends when the
    last request issued has completed."""
    w = Window()
    clock = time.perf_counter
    t0 = clock()
    end = t0 + seconds
    while clock() < end:
        req = next(requests)
        w.attempted += 1
        t = clock()
        try:
            out = call(req)
            sync()
        except Exception as e:           # counted, and the run is not correct
            w.failed += 1
            if len(w.errors) < 3:
                w.errors.append(f"{type(e).__name__}: {e}")
            continue
        w.latencies.append(clock() - t)
        w.classes.append(req[0])
        w.slots.append(req[1])
        sample.offer(req, out)
    w.seconds = clock() - t0
    return w


@dataclass
class Trace:
    """The profiler's slice: the device's operations as (name, start us,
    end us), the slice's requests and its host length."""

    ops: list
    window: Window

    @property
    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device: the union."""
        busy, cur_s, cur_e = 0.0, None, None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e6

    def device_seconds(self, names) -> float:
        """Summed device time of the program's operations whose short name
        is one of ``names`` (PyTorch's own, under ``at::``, are not)."""
        return sum(e - s for n, s, e in self.ops
                   if short_name(n) in names and "at::" not in n) / 1e6


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.split("<")[0].split("(")[0].replace("void ", "").strip()
    return head.split("::")[-1] or name


def device_ops(prof) -> list:
    from torch.autograd import DeviceType
    return [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in prof.events() if ev.device_type == DeviceType.CUDA]


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the idle gaps between
    them by the operations either side, each summed by name."""
    ops: dict[str, float] = {}
    for n, s, e in trace.ops:
        ops[short_name(n)] = ops.get(short_name(n), 0.0) + (e - s) / 1e6
    gaps: dict[str, float] = {}
    last_end, last_name = None, None
    for n, s, e in sorted(trace.ops, key=lambda o: o[1]):
        if last_end is not None and s > last_end:
            key = f"{last_name} -> {short_name(n)}"
            gaps[key] = gaps.get(key, 0.0) + (s - last_end) / 1e6
        if last_end is None or e >= last_end:
            last_end, last_name = e, short_name(n)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


@dataclass
class Run:
    """Everything a metric reader may read."""

    entry: object
    dtype: str
    setup_s: float
    compile_s: float
    window: Window
    trace: Trace | None = None


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def isolate_caches() -> None:
    """Point the port's tuning cache, artifact cache and model store at
    files under ``TMPDIR`` that do not exist, so that tiles come from the
    compiler's plan and not from a file a user or an earlier run left."""
    base = Path(tempfile.gettempdir()) / "portbench-empty"
    for var, fname in (("REPRO_TORCH_TUNING_CACHE", "tuning.json"),
                       ("REPRO_TORCH_COMPILE_CACHE", "compiled.json"),
                       ("REPRO_TORCH_MODEL_STORE", "models.json")):
        path = base / fname
        if path.exists():
            path.unlink()
        os.environ[var] = str(path)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry_mod: object
    e2e: list
    per_layer: list


def load_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    cell = find(bench["workloads"], name, "workload")
    traffic = load_json("traffic", cell["traffic"])
    return Cell(name=name, chips=cell["chips"],
                config=load_config(bench, cell["config"], root),
                traffic=traffic, entry_mod=load_code("entries", traffic["entry"]),
                e2e=cell_metrics(bench, name, "end_to_end"),
                per_layer=cell_metrics(bench, name, "per_layer"))


def sync_fn(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def prepare(cell: Cell, seed: int, device: torch.device):
    """Set-up: the inputs and weights from the seed, the compiles timed
    fresh, every request class warmed.  Returns (entry, compile_s)."""
    from repro_torch.compile.driver import clear_memo
    entry = cell.entry_mod.Entry(cell.config, cell.traffic, seed, device)
    sync = sync_fn(device)
    reps = cell.traffic["compile_repeats"]
    total = 0.0
    for _ in range(reps):
        clear_memo()
        # the collector's counters from zero: each compile meets the same
        # collections, not those that set-up's garbage happens to trigger
        gc.collect()
        t = time.perf_counter()
        entry.compile_set()
        total += time.perf_counter() - t
    for _ in range(WARM_ROUNDS):
        for cls in range(len(entry.classes)):
            entry.call((cls, 0))
        sync()
    entry.reset()
    return entry, total / reps


def judge(entry, cell: Cell, sample: Sample, failed: int) -> tuple[bool, dict]:
    """The numbers compared, each beside its limit, and whether all hold."""
    numbers = entry.check(sample.items())
    limits = cell.traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = (failed == 0 and bool(sample.items())
          and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()))
    return ok, checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             control: bool = False) -> dict:
    """One run; returns the result line as a dict (``checks`` last).  With
    ``control``, the control takes the program's place (calibration only).
    ``t_start`` is when the process started, on ``time.perf_counter``."""
    isolate_caches()
    if device.type == "cuda":
        from repro_torch.kernels.cuda import build_kernels
        build_kernels()
    entry, compile_s = prepare(cell, seed, device)
    call = entry.control if control else entry.call
    sync = sync_fn(device)
    requests = Requests(len(entry.classes), cell.traffic["pool"], seed)
    sample = Sample(len(entry.classes), cell.traffic["sample"], seed)
    sync()
    gc.collect()
    setup_s = time.perf_counter() - t_start
    window = drive(call, sync, requests, sample, seconds)
    result_trace = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = ([ProfilerActivity.CUDA] if device.type == "cuda"
                else [ProfilerActivity.CPU])
        with profile(activities=acts) as prof:
            sliced = drive(call, sync, requests, sample, TRACE_SECONDS)
        result_trace = Trace(ops=device_ops(prof), window=sliced)
        del prof
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = Run(entry=entry, dtype=cell.traffic["dtype"], setup_s=setup_s,
              compile_s=compile_s, window=window, trace=result_trace)
    wanted = cell.per_layer if trace else cell.e2e
    metrics = {}
    for m in wanted:
        value = load_code("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = window.failed + (result_trace.window.failed if trace else 0)
    attempted = window.attempted + (result_trace.window.attempted
                                    if trace else 0)
    entry.free()
    run.entry = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks = judge(entry, cell, sample, failed)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    if trace:
        dev["busy_s"] = result_trace.busy_s
        dev["window_s"] = result_trace.window.seconds
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and result_trace.ops:
        out["breakdown"] = breakdown(result_trace)
    out["errors"] = window.errors + (result_trace.window.errors
                                     if trace else [])
    out["checks"] = checks
    return out


def loaded_banned() -> list[str]:
    """The banned top-level module names loaded in this process."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(BANNED_MODULES))
