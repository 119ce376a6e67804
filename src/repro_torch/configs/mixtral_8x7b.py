"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    n_experts=8, top_k=2,
    sliding_window=4096, rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=96, vocab_size=128, n_experts=4, top_k=2, capacity_factor=8.0, 
                         sliding_window=8, remat=False)
