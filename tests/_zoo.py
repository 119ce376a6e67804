"""Shared helpers of the model zoo's parity tests (``test_torch_models.py``,
``test_torch_whisper.py``, ``test_torch_serve.py``): the JAX package's
weights carried into the port, seeded inputs for both, and the tolerances.

Weights: the JAX ``init(PRNGKey(0))`` of the smoke config, with the leaves
that init leaves degenerate perturbed by seeded numpy before either package
sees them — the QKV biases (zeros), the norm scales (ones), each MoE
expert (one draw repeated E times), the xLSTM gate biases (zeros and
threes), Mamba's conv bias, dt bias, skip and the rows of A_log (log 1..ds
in every row) — so that a swapped bias, a dropped norm scale, a wrong
expert index or a transposed A shows in the outputs.

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

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.steps import eval_shape_cache as jax_eval_shape_cache
from repro.launch.steps import eval_shape_params as jax_eval_shape_params
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch.steps import eval_shape_cache, eval_shape_params
from repro_torch.models.convert import (Stacked, from_jax_params, jax_items,
                                        jax_leaf_index)

#: every arch of the registry
ZOO_ARCHS = list(ARCHS)
DECODER_ARCHS = [a for a in ZOO_ARCHS if a != "whisper-medium"]
DTYPES = ("float32", "bfloat16")
BF16_REL = 1e-2
#: XLA's CPU rewrite that keeps f32 inside fused bf16 chains, off
REF_OPTIONS = {"xla_allow_excess_precision": False}


def jit_ref(fn, **kw):
    return jax.jit(fn, compiler_options=REF_OPTIONS, **kw)


#: leaves the init fills with one value (or one row) that get noise
SHIFTED = ("bq", "bk", "bv", "b_i", "b_f", "b_z", "b_o", "dt_bias", "D_skip",
           "conv_b", "A_log")


def perturb(tree: dict, rng: np.random.Generator) -> dict:
    """Perturb the degenerate leaves of a numpy parameter tree."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out[name] = perturb(node, rng)
            continue
        a = np.asarray(node)
        if name.startswith("norm") or name in SHIFTED:
            a = a + rng.normal(0.0, 0.1, a.shape).astype(a.dtype)
        elif name in ("w_gate", "w_up", "w_down") and a.ndim >= 4:
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


def flat_specs(tree: dict, prefix: str = ""):
    """(path, leaf) of a nested dict, the path "/"-separated."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_specs(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def jax_path(name: str) -> tuple[str, int]:
    """A ``state_dict`` name's leaf path in the JAX tree, and the number of
    stacked axes the JAX leaf has in front: ``blocks.mlstm.0.1.p.wq`` is
    leaf (0, 1) of ``blocks/mlstm/p/wq``."""
    path, idx = jax_leaf_index(name.split("."))
    return "/".join(path), len(idx)


def restacked(tree) -> dict:
    """A port tree (name -> tensor, or a module) as the JAX tree's leaves,
    path -> f32 numpy, its layers stacked."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    return {"/".join(p): as_np(leaf.stack() if isinstance(leaf, Stacked)
                               else leaf) for p, leaf in jax_items(tree)}


def assert_eval_shapes_match(arch: str) -> None:
    """Parameter and cache shapes and dtypes on the ``meta`` device at the
    full config of ``arch``, against the JAX package's ``eval_shape``."""
    cfg = get_config(arch)
    _, state = eval_shape_params(cfg)
    assert all(t.device.type == "meta" for t in state.values())
    _, jtree = jax_eval_shape_params(jax_get_config(arch))
    leaves = dict(flat_specs(jtree))
    assert {jax_path(n)[0] for n in state} == set(leaves)
    for name, t in state.items():
        path, axes = jax_path(name)
        spec = leaves[path]
        assert tuple(t.shape) == tuple(spec.shape[axes:]), name
        assert str(t.dtype) == f"torch.{spec.dtype}", name
    assert sum(t.numel() for t in state.values()) == sum(
        int(np.prod(s.shape)) for s in leaves.values())
    cache = eval_shape_cache(cfg, 2, 64)
    jcache = jax_eval_shape_cache(jax_get_config(arch), 2, 64)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flat_specs(cache)}
    assert got == {k: (tuple(v.shape), str(v.dtype))
                   for k, v in flat_specs(jcache)}
