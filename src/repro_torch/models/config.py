"""Model configuration + shape descriptors for the assigned architectures."""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"       # rmsnorm | nonparam_ln
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0     # >0: SWA (mixtral)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_period: int = 1         # MoE FFN every Nth layer (jamba: 2)
    # hybrid (jamba): one attention layer per `attn_period`, rest mamba
    attn_period: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # xlstm: one sLSTM block per `slstm_period`, rest mLSTM
    slstm_period: int = 0
    mlstm_proj_factor: float = 2.0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    # modality frontend stubs
    frontend_tokens: int = 0    # patches / audio frames provided pre-embedded
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    loss_chunk: int = 0         # 0 = no logits chunking

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ---- parameter count (for MODEL_FLOPS = 6 N D) -------------------------
    def param_count(self, active_only: bool = False) -> int:
        D, H, KV, hd, F, V = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.hd, self.d_ff, self.vocab_size)
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.qkv_bias:
            attn += (H + 2 * KV) * hd
        mlp_dense = 3 * D * F                    # swiglu gate/up/down
        if self.family == "hybrid" and self.attn_period:
            n_attn_layers = self.n_layers // self.attn_period
            n_mamba = self.n_layers - n_attn_layers
            di = self.mamba_expand * D
            mamba = (D * 2 * di + di * self.mamba_d_conv
                     + di * (2 * self.mamba_d_state + 1)
                     + di + di * D)
            total = n_attn_layers * attn + n_mamba * mamba
        elif self.family == "ssm":
            # xlstm mLSTM: in/out proj + block-diagonal per-head qkv + gates
            di = int(self.mlstm_proj_factor * D)
            dh = di // max(self.n_heads, 1)
            mlstm = 2 * D * di + 3 * dh * dh * self.n_heads + 2 * di + di * D
            total = self.n_layers * mlstm
        else:
            total = self.n_layers * attn
        if self.family != "ssm":
            n_moe = self.n_layers // self.moe_period if self.n_experts else 0
            n_dense = self.n_layers - n_moe
            if n_moe:
                experts = self.n_experts * mlp_dense + D * self.n_experts
                active = self.top_k * mlp_dense + D * self.n_experts
                total += n_moe * (active if active_only else experts)
            total += n_dense * mlp_dense
        total += 2 * D  # final norm(s)
        total += V * D * (1 if self.tie_embeddings else 2)
        if self.encoder_layers:
            total += self.encoder_layers * (attn + mlp_dense)  # encoder stack
            total += self.n_layers * attn                      # cross attention
        return int(total)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the assigned input-shape cells."""
    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: archs with quadratic full attention skip long_500k (see DESIGN.md)
FULL_ATTENTION_ARCHS = {
    "olmo-1b", "qwen2-7b", "qwen1.5-32b", "qwen2.5-32b", "llava-next-34b",
    "whisper-medium",
}


def shape_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k" and arch in FULL_ATTENTION_ARCHS:
        return False
    return True
