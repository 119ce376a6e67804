"""Persistent ``CompiledKernel`` artifact cache.

Keyed by ``keys.artifact_key`` — (program fingerprint, sysgraph
fingerprint, *approach* fingerprint, backend, ISA fingerprint, transform
policy, torch version) — so an artifact is reused only when the whole
compile is reproducible: a different machine description, a different config
vector or a toolchain bump all miss.  One JSON file, atomic writes,
warn-once on a corrupt file (same contract as the tuning cache), and every
payload is checked (``verify_artifact_dict``) before it is hydrated.

The port keeps its own file (``REPRO_TORCH_COMPILE_CACHE``, default
``~/.cache/repro_torch/compiled.json``); it never shares one with the JAX
package.  The process-wide default cache is *opt-in*
(``set_default_artifact_cache``): library entry points like ``plan_gemm``
stay purely in-memory-memoized unless a caller (``chip_smoke.py``, a test)
activates a cache.
"""
from __future__ import annotations

import json
import os
import tempfile

from ..search.cache import CACHE_ERRORS, file_lock, warn_corrupt_cache
from .artifact import ARTIFACT_SCHEMA, CompiledKernel

#: Override the default artifact-cache location (e.g. in CI).
CACHE_ENV_VAR = "REPRO_TORCH_COMPILE_CACHE"


def default_artifact_cache_path() -> str:
    env = os.environ.get(CACHE_ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "compiled.json")


class ArtifactCache:
    """Dict of ``CompiledKernel`` dicts with JSON persistence."""

    def __init__(self, path: str | None = None):
        self.path = path or default_artifact_cache_path()
        self._entries: dict[str, dict] | None = None

    # -- persistence ---------------------------------------------------------
    def load(self) -> dict[str, dict]:
        if self._entries is None:
            entries: dict[str, dict] = {}
            raw = None
            try:
                with open(self.path) as f:
                    raw = json.load(f)
            except OSError:
                pass                          # missing file = empty cache
            except ValueError as e:           # json.JSONDecodeError
                warn_corrupt_cache(self.path, e)
            if isinstance(raw, dict):
                for d in raw.get("artifacts", []):
                    if isinstance(d, dict) and "key" in d:
                        entries[d["key"]] = d
            self._entries = entries
        return self._entries

    def save(self) -> None:
        # Merge-on-save under the same advisory file lock as the tuning
        # cache: concurrent savers serialize, so parallel tuner workers
        # cannot drop each other's artifacts.
        with file_lock(self.path):
            self._save_locked()

    def _save_locked(self) -> None:
        ours = dict(self.load())
        entries = ArtifactCache(self.path).load()
        entries.update(ours)
        self._entries = entries
        payload = {"schema": ARTIFACT_SCHEMA,
                   "artifacts": list(entries.values())}
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

    # -- access --------------------------------------------------------------
    def lookup(self, key: str) -> CompiledKernel | None:
        d = self.load().get(key)
        if d is None:
            return None
        from ..verify import verify_artifact_dict
        diags = verify_artifact_dict(d)
        if diags:
            warn_corrupt_cache(
                self.path,
                ValueError(f"artifact {key!r} failed payload verification: "
                           + "; ".join(str(x) for x in diags[:3])))
            return None
        try:
            return CompiledKernel.from_dict(d)
        except CACHE_ERRORS as e:
            warn_corrupt_cache(self.path, e)
            return None

    def store(self, artifact: CompiledKernel, save: bool = True) -> None:
        self.load()[artifact.key] = artifact.to_dict()
        if save:
            self.save()

    def keys(self):
        return self.load().keys()

    def __len__(self) -> int:
        return len(self.load())

    def __contains__(self, key: str) -> bool:
        return key in self.load()


# --------------------------------------------------------------------------- #
# Process-wide default cache (opt-in)
# --------------------------------------------------------------------------- #

_default_cache: ArtifactCache | None = None


def get_default_artifact_cache() -> ArtifactCache | None:
    """The active artifact cache, or None when none has been activated."""
    return _default_cache


def set_default_artifact_cache(cache: ArtifactCache | None) -> None:
    """Activate (or deactivate) the process-wide artifact cache — used by
    ``chip_smoke.py`` and tests."""
    global _default_cache
    _default_cache = cache
