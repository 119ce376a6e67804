"""whisper-medium [audio]: 24L(+24 enc) d_model=1024 16H (kv=16) d_ff=4096
vocab=51865 — encoder-decoder; conv frontend STUB (input_specs provides
precomputed frame embeddings) [arXiv:2212.04356; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    encoder_layers=24,
    frontend_tokens=1500,         # 30s of audio at 50 Hz after conv stub
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=128, encoder_layers=2,
                         frontend_tokens=16, remat=False)
