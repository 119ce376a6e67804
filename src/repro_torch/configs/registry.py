"""Architecture registry: ``get_config(arch)`` + ``input_specs(cfg, shape)``.

Each assigned architecture lives in its own module defining ``CONFIG`` (the
exact published configuration) and ``smoke_config()`` (a reduced same-family
variant for CPU smoke tests)."""
from __future__ import annotations

import importlib

import torch

from ..models.config import SHAPES, ModelConfig, ShapeConfig, shape_applicable

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


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                for_train: bool | None = None) -> dict:
    """Stand-ins for every model input of this cell: tensors on the ``meta``
    device, with the shapes and dtypes of the real inputs and no
    allocation."""
    B, T = shape.global_batch, shape.seq_len
    i32 = torch.int32
    f = cfg.activation_dtype

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec((B,), i32)}
    specs = {"tokens": spec((B, T), i32)}
    if cfg.family == "vlm":
        n_patches = cfg.frontend_tokens or 576
        specs["patch_embeds"] = spec((B, n_patches, cfg.d_model), f)
    if cfg.family == "audio":
        n_frames = cfg.frontend_tokens or 1500
        specs["audio_embeds"] = spec((B, n_frames, cfg.d_model), f)
    return specs


def cell_applicable(arch: str, shape_name: str) -> bool:
    return shape_applicable(arch, shape_name)


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]
