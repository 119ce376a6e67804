"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16 experts top-2, Mamba:attention 7:1 interleave
[arXiv:2403.19887; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    n_experts=16, top_k=2, moe_period=2,
    attn_period=8, mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=96, vocab_size=128, n_experts=4, top_k=2, capacity_factor=8.0, 
                         attn_period=2, remat=False)
