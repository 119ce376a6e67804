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
  * ``tune``       — the ``python -m repro_torch.search.tune`` CLI.
"""
from .cache import TuningCache, TuningRecord, default_cache_path, get_default_cache
from .space import ParamApproach, SearchSpace, program_fingerprint, tuning_key
from .strategies import STRATEGIES, SearchOutcome, Trial

__all__ = [
    "ParamApproach", "SearchSpace", "program_fingerprint", "tuning_key",
    "STRATEGIES", "SearchOutcome", "Trial",
    "TuningCache", "TuningRecord", "default_cache_path", "get_default_cache",
]
