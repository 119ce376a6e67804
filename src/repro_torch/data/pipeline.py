"""Deterministic, step-keyed data pipeline.

Batches are pure functions of (seed, step) — after a restart the pipeline
resumes mid-stream with no replay drift and no state to checkpoint.  Sources:
``SyntheticLM`` (structured pseudo-text: mixture of Zipfian unigrams and
repeated n-grams so models have something learnable) and ``TokenFileSource``
(memory-mapped pre-tokenized corpus).  The sources are numpy, byte for byte
the JAX package's; ``host_local_batch`` puts a batch on the trainer's
placement.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..dist.sharding import place
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    source: str = "synthetic"       # synthetic | file
    path: str = ""


def _step_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    h = hashlib.sha256(f"{cfg.seed}:{step}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


class SyntheticLM:
    """Zipf unigrams + planted n-gram motifs (learnable structure)."""

    def __init__(self, cfg: DataConfig, vocab_size: int):
        self.cfg = cfg
        self.vocab = vocab_size
        base = np.random.default_rng(cfg.seed)
        n_motifs = 64
        self.motifs = base.integers(0, vocab_size,
                                    size=(n_motifs, 8)).astype(np.int32)

    def batch(self, step: int) -> dict:
        rng = _step_rng(self.cfg, step)
        B, T = self.cfg.global_batch, self.cfg.seq_len
        # Zipfian unigram background
        ranks = rng.zipf(1.3, size=(B, T)).astype(np.int64)
        tokens = (ranks % self.vocab).astype(np.int32)
        # plant motifs: ~25% of positions covered by repeated 8-grams
        n_plants = max(1, (B * T) // 32)
        rows = rng.integers(0, B, n_plants)
        cols = rng.integers(0, max(T - 8, 1), n_plants)
        which = rng.integers(0, len(self.motifs), n_plants)
        for r, c, w in zip(rows, cols, which):
            tokens[r, c:c + 8] = self.motifs[w]
        return {"tokens": tokens}


class TokenFileSource:
    """Memory-mapped int32 token file; step-keyed random windows."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch(self, step: int) -> dict:
        rng = _step_rng(self.cfg, step)
        B, T = self.cfg.global_batch, self.cfg.seq_len
        starts = rng.integers(0, len(self.data) - T - 1, size=B)
        toks = np.stack([self.data[s:s + T] for s in starts])
        return {"tokens": toks.astype(np.int32)}


def make_source(cfg: DataConfig, model_cfg: ModelConfig):
    if cfg.source == "file":
        return TokenFileSource(cfg)
    return SyntheticLM(cfg, model_cfg.vocab_size)


def host_local_batch(batch: dict, mesh, shardings) -> dict:
    """Put a host batch (numpy arrays or CPU tensors) on its training
    placement (``dist.sharding.place``): on a ``DistMesh`` every rank builds
    the same global batch from the seed and keeps its piece of it, cut by
    ``distribute_tensor`` (``batch_shardings``); else on the device."""
    return {k: place(v, shardings[k]) for k, v in batch.items()}


def add_frontend_stub(batch: dict, model_cfg: ModelConfig, step: int,
                      seed: int = 0) -> dict:
    """VLM / audio archs: attach deterministic precomputed embeddings.  They
    are drawn in f32 with numpy, as in the JAX package, and cast to the
    activation dtype by torch (numpy has no bfloat16): a CPU tensor."""
    if model_cfg.family not in ("vlm", "audio"):
        return batch
    B = batch["tokens"].shape[0]
    rng = np.random.default_rng(seed * 7919 + step)
    emb = rng.standard_normal(
        (B, model_cfg.frontend_tokens, model_cfg.d_model)).astype(np.float32)
    key = "patch_embeds" if model_cfg.family == "vlm" else "audio_embeds"
    out = dict(batch)
    out[key] = torch.from_numpy(emb * 0.02).to(model_cfg.activation_dtype)
    return out
