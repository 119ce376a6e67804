"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres patch tiling (frontend STUB: input_specs provides
precomputed patch embeddings) [hf:llava-hf/llava-v1.6...; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    frontend_tokens=576,          # anyres base grid 24x24
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=128, frontend_tokens=8,
                         remat=False)
