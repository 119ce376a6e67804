"""Persistent tuning cache (paper Section 4 "remember winners").

One JSON file maps tuning keys — ``(program fingerprint, sysgraph, backend,
torch version)``, see ``space.tuning_key`` — to the winning config vector
plus provenance (strategy, trials, modeled costs, resolved GEMM block).  The
cache is what makes search pay off across runs: ``kernels/gemm.py`` and
``kernels/ops.py`` consult it at run time, so a shape tuned once keeps its
block until the toolchain (torch version) or machine description changes.
The port keeps its own file (``REPRO_TORCH_TUNING_CACHE``, default
``~/.cache/repro_torch/tuning.json``); it never shares one with the JAX
package.

Writes are atomic (tmp + rename) and reads are tolerant: a missing file is
an empty cache; a *corrupt* file is an empty cache too, but warns once per
path so a damaged cache never degrades performance silently.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import warnings
from dataclasses import dataclass, field
from functools import lru_cache

try:                                    # POSIX advisory locks
    import fcntl
except ImportError:                     # pragma: no cover - non-POSIX
    fcntl = None

SCHEMA_VERSION = 1

#: Override the default cache location (e.g. in CI).
CACHE_ENV_VAR = "REPRO_TORCH_TUNING_CACHE"

#: The error types a persistent-cache lookup can legitimately raise — what
#: cache-consulting call sites (``kernels.ops.plan_gemm``,
#: ``kernels.gemm.tuned_block``) catch instead of a bare ``Exception``.
CACHE_ERRORS = (OSError, ValueError, KeyError, TypeError)

_warned_corrupt: set[str] = set()


def warn_corrupt_cache(path: str, err: Exception) -> None:
    """Warn exactly once per path about an unreadable cache file (a
    corrupt file degrades to an empty cache, but never silently)."""
    if path in _warned_corrupt:
        return
    _warned_corrupt.add(path)
    warnings.warn(f"ignoring corrupt cache file {path}: {err}", stacklevel=3)


@contextlib.contextmanager
def file_lock(path: str):
    """Advisory inter-process lock on ``path + '.lock'``.

    Serializes the merge-on-save read-modify-write of the persistent caches
    so parallel tuner workers (``tune --workers N``) cannot interleave
    between a save's re-read and its atomic replace — without the lock a
    racing pair can each merge against the *pre*-race file and the second
    ``os.replace`` silently drops the first writer's keys.  Locking is
    best-effort: on platforms without ``fcntl`` the context is a no-op and
    saves fall back to the documented last-writer-wins-per-key race."""
    if fcntl is None:                   # pragma: no cover - non-POSIX
        yield
        return
    lock_path = os.path.abspath(path) + ".lock"
    os.makedirs(os.path.dirname(lock_path), exist_ok=True)
    with open(lock_path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def default_cache_path() -> str:
    env = os.environ.get(CACHE_ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "tuning.json")


@dataclass
class TuningRecord:
    """The winner for one (program, machine, backend, toolchain) cell."""

    key: str
    config: dict
    cost: float                     # tuned cost (modeled s, or measured s)
    baseline_cost: float            # GreedyApproach cost at tuning time
    backend: str = "cost"           # 'cost' | 'measure'
    strategy: str = ""
    trials: int = 0
    tile: tuple | None = None       # resolved (bm, bn, bk) for GEMM cases
    meta: dict = field(default_factory=dict)

    @property
    def speedup(self) -> float:
        return self.baseline_cost / self.cost if self.cost > 0 else 1.0

    def to_dict(self) -> dict:
        d = {"key": self.key, "config": self.config, "cost": self.cost,
             "baseline_cost": self.baseline_cost, "backend": self.backend,
             "strategy": self.strategy, "trials": self.trials,
             "meta": self.meta}
        if self.tile is not None:
            d["tile"] = list(self.tile)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TuningRecord":
        tile = d.get("tile")
        return cls(key=d["key"], config=dict(d.get("config", {})),
                   cost=float(d.get("cost", 0.0)),
                   baseline_cost=float(d.get("baseline_cost", 0.0)),
                   backend=d.get("backend", "cost"),
                   strategy=d.get("strategy", ""),
                   trials=int(d.get("trials", 0)),
                   tile=tuple(int(x) for x in tile) if tile else None,
                   meta=dict(d.get("meta", {})))


class JsonStore:
    """Shared keyed-JSON-artifact persistence — the one implementation of
    lazy load with corrupt-file tolerance, merge-on-save, and atomic
    replace behind both the tuning cache and the learned-cost-model store
    (``repro_torch.search.model.ModelStore``).

    Subclasses set ``payload_key``/``schema`` and the entry codecs
    (``_decode`` raising ``KeyError/TypeError/ValueError`` on malformed
    entries, which are skipped).  Entries expose ``.key``.
    """

    payload_key = "records"
    schema = SCHEMA_VERSION

    def __init__(self, path: str | None = None):
        self.path = path or self.default_path()
        self._entries: dict | None = None

    def default_path(self) -> str:          # pragma: no cover - subclassed
        raise NotImplementedError

    def _decode(self, d: dict):             # pragma: no cover - subclassed
        raise NotImplementedError

    def _encode(self, obj) -> dict:
        return obj.to_dict()

    # -- persistence ---------------------------------------------------------
    def load(self) -> dict:
        if self._entries is None:
            entries: dict = {}
            raw = None
            try:
                with open(self.path) as f:
                    raw = json.load(f)
            except OSError:
                pass                        # missing file = empty store
            except ValueError as e:         # json.JSONDecodeError
                warn_corrupt_cache(self.path, e)
            if isinstance(raw, dict):
                for d in raw.get(self.payload_key, []):
                    try:
                        obj = self._decode(d)
                        entries[obj.key] = obj
                    except (KeyError, TypeError, ValueError):
                        continue            # skip malformed entry
            self._entries = entries
        return self._entries

    def save(self) -> None:
        # Merge-on-save under the advisory file lock: re-read the file so
        # entries another process stored since our first load survive (last
        # writer wins per *key*, not per file), and no concurrent save can
        # interleave between the re-read and the atomic replace.
        with file_lock(self.path):
            self._save_locked()

    def _save_locked(self) -> None:
        ours = dict(self.load())
        entries = type(self)(self.path).load()
        entries.update(ours)
        self._entries = entries
        payload = {"schema": self.schema,
                   self.payload_key: [self._encode(o)
                                      for o in entries.values()]}
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- access ---------------------------------------------------------------
    def lookup(self, key: str):
        return self.load().get(key)

    def store(self, obj, save: bool = True) -> None:
        self.load()[obj.key] = obj
        if save:
            self.save()

    def keys(self):
        return self.load().keys()

    def __len__(self) -> int:
        return len(self.load())

    def __contains__(self, key: str) -> bool:
        return key in self.load()


class TuningCache(JsonStore):
    """Dict-of-``TuningRecord`` with JSON persistence."""

    payload_key = "records"
    schema = SCHEMA_VERSION

    def default_path(self) -> str:
        return default_cache_path()

    def _decode(self, d: dict) -> TuningRecord:
        return TuningRecord.from_dict(d)


# --------------------------------------------------------------------------- #
# Process-wide default cache (what the kernels consult at run time)
# --------------------------------------------------------------------------- #

_default_cache: TuningCache | None = None


def get_default_cache() -> TuningCache:
    global _default_cache
    if _default_cache is None:
        _default_cache = TuningCache()
    return _default_cache


def set_default_cache(cache: TuningCache | None) -> None:
    """Point the process at a specific cache (tests, --tuned launches)."""
    global _default_cache
    _default_cache = cache


# --------------------------------------------------------------------------- #
# GEMM convenience lookups (the kernels' entry point)
# --------------------------------------------------------------------------- #


def clamp_tile(tile, m: int, n: int, k: int) -> tuple[int, int, int]:
    """Clamp a recorded/requested (bm, bn, bk) block to an (m, n, k)
    problem — the one definition shared by ``kernels.gemm.tuned_block``,
    ``kernels.ops.plan_gemm`` and ``search.evaluate.gemm_tile_for``."""
    bm, bn, bk = (int(x) for x in tile)
    return (max(1, min(bm, m)), max(1, min(bn, n)), max(1, min(bk, k)))


def gemm_tuning_key(m: int, n: int, k: int, graph=None,
                    backend: str = "cost") -> str:
    """Cache key for the canonical (m, n, k) GEMM program on ``graph``
    (default: ``gpu_sm(8)``, the modeled GPU the kernels schedule
    against)."""
    if graph is None:
        return _default_gemm_key(m, n, k, backend)
    from ..core import kernels_ir as K
    from .space import tuning_key
    return tuning_key(K.matmul(m, n, k), graph, backend)


@lru_cache(maxsize=1024)
def _default_gemm_key(m: int, n: int, k: int, backend: str) -> str:
    from ..core import kernels_ir as K
    from ..core.sysgraph import gpu_sm
    from .space import tuning_key
    return tuning_key(K.matmul(m, n, k), gpu_sm(8), backend)


def lookup_gemm(m: int, n: int, k: int, graph=None,
                cache: TuningCache | None = None) -> TuningRecord | None:
    """Best tuned record for an (m, n, k) GEMM; measured wall-clock wins
    over cost-model records when both exist."""
    cache = cache or get_default_cache()
    for backend in ("measure", "cost"):
        rec = cache.lookup(gemm_tuning_key(m, n, k, graph, backend))
        if rec is not None:
            return rec
    return None
