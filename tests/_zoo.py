"""Shared helpers of the model zoo's parity tests (``test_torch_models.py``,
``test_torch_whisper.py``, ``test_torch_serve.py``): the JAX package's
weights carried into the port, seeded inputs for both, and the tolerances.

Weights: the JAX ``init(PRNGKey(0))`` of the smoke config, with the leaves
that init leaves degenerate perturbed by seeded numpy before either package
sees them — the QKV biases (zeros), the norm scales (ones) and each MoE
expert (one draw repeated E times) — so that a swapped bias, a dropped
norm scale or a wrong expert index shows in the outputs.

The JAX side runs compiled, with XLA's excess precision off
(``jit_ref``).  On the CPU, XLA otherwise keeps f32 values inside fused
bf16 chains (``xla_allow_excess_precision``, on by default), so a compiled
JAX function rounds fewer intermediates than the same function evaluated op
by op; with it off, JAX's compiled functions round every op to bf16 as its
eager functions do and as the port does.  In f32 the option changes
nothing.

Tolerances: f32 rtol = atol = 1e-5 (JAX's attention-arch tolerance is
1e-3); bf16 max|got - want| <= 1e-2 * max|want|, half the bound of 2e-2 the
JAX package's bf16 tests use (the port agrees bit for bit on most archs;
rotary's f32 ``cos``, one ulp apart in a few entries, is the residue).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.models.convert import from_jax_params

#: the attention families the port serves (xlstm and jamba are not ported)
ZOO_ARCHS = [a for a in ARCHS if a not in ("xlstm-1.3b",
                                           "jamba-1.5-large-398b")]
DECODER_ARCHS = [a for a in ZOO_ARCHS if a != "whisper-medium"]
DTYPES = ("float32", "bfloat16")
BF16_REL = 1e-2
#: XLA's CPU rewrite that keeps f32 inside fused bf16 chains, off
REF_OPTIONS = {"xla_allow_excess_precision": False}


def jit_ref(fn, **kw):
    return jax.jit(fn, compiler_options=REF_OPTIONS, **kw)


def perturb(tree: dict, rng: np.random.Generator) -> dict:
    """Perturb the degenerate leaves of a numpy parameter tree."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out[name] = perturb(node, rng)
            continue
        a = np.asarray(node)
        if name.startswith("norm") or name in ("bq", "bk", "bv"):
            a = a + rng.normal(0.0, 0.1, a.shape).astype(a.dtype)
        elif name in ("w_gate", "w_up", "w_down") and a.ndim == 4:
            # stacked layers x experts: scale each expert differently
            a = a * (1.0 + rng.normal(0.0, 0.3, a.shape)).astype(a.dtype)
        out[name] = a
    return out


def configs(arch: str, dtype: str, **over):
    return (jax_smoke_config(arch).scaled(dtype=dtype, **over),
            get_smoke_config(arch).scaled(dtype=dtype, **over))


@functools.lru_cache(maxsize=None)
def _numpy_params(arch: str, over: tuple) -> dict:
    cfg = jax_smoke_config(arch).scaled(**dict(over))
    tree = jax.tree.map(np.asarray,
                        jax_build_model(cfg).init(jax.random.PRNGKey(0)))
    return perturb(tree, np.random.default_rng(1))


def pair(arch: str, dtype: str, **over):
    """(JAX model, its params, the port's model on the CPU with the same
    values) of the smoke config at activation ``dtype``."""
    jcfg, tcfg = configs(arch, dtype, **over)
    tree = _numpy_params(arch, tuple(sorted(over.items())))
    return (jax_build_model(jcfg), jax.tree.map(jnp.asarray, tree),
            from_jax_params(tcfg, tree, device="cpu"))


def batches(cfg, B: int = 2, T: int = 8, seed: int = 2):
    """The same seeded batch for both packages: tokens, and the frontend
    stub's embeddings for the VLM and audio families."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    key = {"vlm": "patch_embeds", "audio": "audio_embeds"}.get(cfg.family)
    if key:
        e = rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)
                       ).astype(np.float32)
        jb[key] = jnp.asarray(e).astype(cfg.dtype)
        tb[key] = torch.from_numpy(e).to(getattr(torch, cfg.dtype))
    return jb, tb


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, dtype: str, what: str = "") -> None:
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        err = float(np.abs(got - want).max())
        assert err <= BF16_REL * float(np.abs(want).max()), (what, err)


def assert_tree_close(got: dict, want: dict, dtype: str, what: str = ""):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_close(got[k], want[k], dtype, f"{what}/{k}")
        else:
            assert_close(got[k], want[k], dtype, f"{what}/{k}")


class JittedModel:
    """A JAX model whose serving methods are compiled with ``REF_OPTIONS``,
    for the JAX package's own ``generate`` loop."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.prefill = jit_ref(model.prefill, static_argnames="max_len")
        self.decode_step = jit_ref(model.decode_step)


def tokens_agree(got, want, logits, dtype: str) -> None:
    """Greedy tokens: equal in f32; in bf16 equal up to the first step
    where the port's top-2 margin is within the bf16 tolerance (there a
    rounding may pick the other token, and the streams part)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    lg = as_np(logits)                     # (B, steps, V)
    top2 = np.sort(lg, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) \
        <= BF16_REL * np.abs(lg).max(axis=-1)
    for b in range(got.shape[0]):
        for i in range(got.shape[1]):
            if close[b, i]:
                break
            assert got[b, i] == want[b, i], (b, i)
