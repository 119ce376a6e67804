"""repro_torch.search — joint mapping/schedule autotuning (paper Section 4).

The paper frames the compiler's combinatorial choices as a *flexible
framework that allows heuristics, cost models, and potentially machine
learning*.  This package is that framework's search driver:

  * ``space``      — ``ParamApproach``: every Approach decision point driven
                     by an explicit, enumerable config vector; the tuning
                     key over the compiler's program and system-graph
                     fingerprints.
  * ``strategies`` — seeded, deterministic search strategies over the space
                     (random sampling, greedy hill-climb, evolutionary,
                     surrogate-ranked).
  * ``batch``      — vectorized population guard + schedule keys.
  * ``evaluate``   — evaluation backends: fast modeled-makespan dry-runs
                     and K1 timed on the CUDA card, plus executor-vs-oracle
                     validation of winning schedules.
  * ``cache``      — persistent JSON tuning cache keyed by (program
                     fingerprint, sysgraph, backend, torch version),
                     consulted by ``repro_torch.kernels`` at run time.
  * ``model``      — the **learned** cost model: deterministic numpy ridge
                     regression over engineered feature vectors, trained
                     from cache records + fresh cost-model labels, stored as
                     JSON artifacts keyed per (program family, sysgraph,
                     backend, torch version); drives ``surrogate`` search
                     and ``kernels.gemm.tuned_block`` on a cache miss.
  * ``tune``       — the ``python -m repro_torch.search.tune`` CLI.
"""
from .cache import TuningCache, TuningRecord, default_cache_path, get_default_cache
from .space import ParamApproach, SearchSpace, program_fingerprint, tuning_key
from .strategies import STRATEGIES, SearchOutcome, Trial

_MODEL_EXPORTS = ("CostModel", "ModelStore", "default_store_path",
                  "model_key")


def __getattr__(name):
    # Lazy: ``python -m repro_torch.search.model`` must not find the
    # submodule pre-imported (runpy warns), and the cache/space fast paths
    # shouldn't pay for numpy-heavy model code they never use.
    if name in _MODEL_EXPORTS:
        from . import model
        return getattr(model, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CostModel", "ModelStore", "default_store_path", "model_key",
    "ParamApproach", "SearchSpace", "program_fingerprint", "tuning_key",
    "STRATEGIES", "SearchOutcome", "Trial",
    "TuningCache", "TuningRecord", "default_cache_path", "get_default_cache",
]
