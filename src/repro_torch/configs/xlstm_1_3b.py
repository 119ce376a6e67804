"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks, xLSTM[7:1] interleave [arXiv:2405.04517; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_period=8, mlstm_proj_factor=2.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                         vocab_size=128, slstm_period=2, remat=False)
