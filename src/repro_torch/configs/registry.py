"""Architecture registry: ``get_config(arch)`` and the reduced variants.

Each assigned architecture lives in its own module defining ``CONFIG`` (the
exact published configuration) and ``smoke_config()`` (a reduced same-family
variant for CPU smoke tests).  ``input_specs`` (the model inputs of a shape
cell) comes with the model zoo."""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = [
    "xlstm-1.3b",
    "olmo-1b",
    "qwen2-7b",
    "qwen1.5-32b",
    "qwen2.5-32b",
    "phi3.5-moe-42b-a6.6b",
    "mixtral-8x7b",
    "llava-next-34b",
    "jamba-1.5-large-398b",
    "whisper-medium",
]


def _module(arch: str):
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def get_trace_config(arch: str) -> ModelConfig:
    """A scaled-down config sized for the graph tracer (``repro_torch.graph``):
    one layer, dense-block dims small enough for the NumPy oracle, and a
    power-of-4 head_dim so the attention score scale is exact (see
    ``repro_torch.graph.trace``)."""
    return get_config(arch).scaled(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=64, n_experts=0, remat=False)
