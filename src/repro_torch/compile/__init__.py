"""The pass-based compilation driver.

    Program ──Map──▶ candidates ──Select──▶ Selection ──Schedule──▶
        Schedule ──Verify──▶ ──Lower──▶ CompiledKernel

  * ``pipeline`` — ``Pipeline`` + the Map / Select / Schedule / Verify /
                   Lower passes over a ``CompileContext``;
  * ``artifact`` — the serializable ``CompiledKernel``: role-keyed tile plan,
                   lowering config, modeled cost;
  * ``keys``     — program / sysgraph / approach / ISA fingerprints and the
                   artifact key;
  * ``cache``    — the persistent artifact cache, keyed by ``keys``;
  * ``driver``   — ``compile_program`` / ``compile_gemm`` / ``compile_gru`` /
                   ``compile_conv`` / ``compile_selection`` /
                   ``compile_fabric`` and the in-process memo;
  * ``features`` — engineered feature vectors over (config, program, graph)
                   triples + ``CompiledKernel`` descriptors, the input
                   representation of the learned cost model
                   (``repro_torch.search.model``).
"""
from .artifact import CompiledKernel, CompileError, InstrPlan
from .cache import (ArtifactCache, default_artifact_cache_path,
                    get_default_artifact_cache, set_default_artifact_cache)
from .driver import (compile_conv, compile_fabric, compile_gemm, compile_gru,
                     compile_program, compile_selection, conv_selection,
                     gemm_selection, gru_selection, resolve_approach,
                     select_program)
from .features import (artifact_features, feature_dict, feature_names,
                       feature_vector, program_family)
from .pipeline import (CompileContext, LowerPass, MapPass, Pipeline,
                       SchedulePass, SelectPass, VerifyPass)

__all__ = [
    "ArtifactCache", "CompileContext", "CompiledKernel", "CompileError",
    "InstrPlan", "LowerPass", "MapPass", "Pipeline", "SchedulePass",
    "SelectPass", "VerifyPass", "artifact_features", "compile_conv",
    "compile_fabric", "compile_gemm", "compile_gru", "compile_program",
    "compile_selection", "conv_selection", "default_artifact_cache_path",
    "feature_dict", "feature_names", "feature_vector", "gemm_selection",
    "get_default_artifact_cache", "gru_selection", "program_family",
    "resolve_approach", "select_program", "set_default_artifact_cache",
]
