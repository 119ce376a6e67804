"""The process-wide caches a ``--tuned`` driver points at.

Shared by the trainer and the server.
"""
from __future__ import annotations


def activate_caches(tuning_path=None, compile_path=None, tag="tuned",
                    model_path=None):
    """--tuned: point the process at the port's persistent tuning cache *and*
    its compile artifact cache, so every cache-aware entry point
    (``tuned_block``/``plan_gemm``/``compile_gemm``...) reuses recorded
    winners and compiled artifacts.  ``model_path`` additionally activates
    the learned-cost-model store: GEMM shapes with no cache record get a
    model-predicted block instead of the static default."""
    from ..compile.cache import ArtifactCache, set_default_artifact_cache
    from ..search.cache import TuningCache, set_default_cache
    cache = TuningCache(tuning_path)
    set_default_cache(cache)
    if model_path is not None:
        from ..search.model import ModelStore, set_default_store
        store = ModelStore(model_path)
        set_default_store(store)
        print(f"[{tag}] model store {store.path}: {len(store)} model(s)")
    print(f"[{tag}] tuning cache {cache.path}: {len(cache)} entries")
    for key in sorted(cache.keys()):
        rec = cache.lookup(key)
        print(f"[{tag}]   {rec.meta.get('case', key)}: "
              f"{rec.speedup:.2f}x ({rec.backend}/{rec.strategy})")
    acache = ArtifactCache(compile_path)
    set_default_artifact_cache(acache)
    print(f"[{tag}] compile artifact cache {acache.path}: "
          f"{len(acache)} artifact(s)")
    for key in sorted(acache.keys()):
        art = acache.lookup(key)
        if art is not None:
            print(f"[{tag}]   {art.program_name} on {art.graph_name}: "
                  f"cost={art.cost:.3e}s "
                  f"lowering={art.lowering.get('kind', '-')}")
    return cache, acache
