"""The pass-based compilation driver.

    Program ──Map──▶ candidates ──Select──▶ Selection ──Schedule──▶
        Schedule ──Lower──▶ CompiledKernel

  * ``pipeline`` — ``Pipeline`` + the Map / Select / Schedule / Lower passes
                   over a ``CompileContext``;
  * ``artifact`` — the serializable ``CompiledKernel``: role-keyed tile plan,
                   lowering config, modeled cost;
  * ``keys``     — program / sysgraph / approach / ISA fingerprints and the
                   artifact key;
  * ``driver``   — ``compile_program`` / ``compile_gemm`` / ``compile_gru`` /
                   ``compile_selection`` and the in-process memo.
"""
from .artifact import CompiledKernel, CompileError, InstrPlan
from .driver import (compile_gemm, compile_gru, compile_program,
                     compile_selection, gemm_selection, gru_selection,
                     resolve_approach, select_program)
from .pipeline import (CompileContext, LowerPass, MapPass, Pipeline,
                       SchedulePass, SelectPass)

__all__ = [
    "CompileContext", "CompiledKernel", "CompileError", "InstrPlan",
    "LowerPass", "MapPass", "Pipeline", "SchedulePass", "SelectPass",
    "compile_gemm", "compile_gru", "compile_program", "compile_selection",
    "gemm_selection", "gru_selection", "resolve_approach", "select_program",
]
