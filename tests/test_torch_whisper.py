"""The port's whisper (``repro_torch.models.whisper``) against the JAX
package's, on the CPU, on whisper-medium's smoke config: the encoder,
teacher-forced ``logits`` and ``loss``, ``prefill`` with its self and cross
KV caches, three ``decode_step``s and greedy ``generate``, in f32 and bf16,
with ``_zoo``'s weights, inputs and tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _zoo import (DTYPES, JittedModel, assert_close, assert_tree_close,
                  batches, jit_ref, pair, tokens_agree)
from repro.launch.serve import generate as jax_generate
from repro_torch.launch.serve import generate

ARCH = "whisper-medium"


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_matches_jax_package(dtype):
    jm, jp, tm = pair(ARCH, dtype)
    jb, tb = batches(tm.cfg)
    want = jit_ref(jm.encode)(jp, jb["audio_embeds"])
    with torch.no_grad():
        got = tm.encode(tb["audio_embeds"])
    assert got.shape == (2, tm.cfg.frontend_tokens, tm.cfg.d_model)
    assert_close(got, want, dtype, "encoder")


@pytest.mark.parametrize("dtype", DTYPES)
def test_logits_and_loss_match_jax_package(dtype):
    jm, jp, tm = pair(ARCH, dtype)
    jb, tb = batches(tm.cfg)
    with torch.no_grad():
        got, loss = tm.logits(tb), float(tm.loss(tb))
    assert_close(got, jit_ref(jm.logits)(jp, jb), dtype, "logits")
    want = float(jit_ref(jm.loss)(jp, jb))
    assert abs(loss - want) <= (1e-5 if dtype == "float32" else 1e-2) * want


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_steps_match_jax_package(dtype):
    jm, jp, tm = pair(ARCH, dtype)
    jb, tb = batches(tm.cfg, T=7)
    jcache, jlast = jit_ref(jm.prefill, static_argnames="max_len")(
        jp, jb, max_len=10)
    tcache, tlast = tm.prefill(tb, max_len=10)
    assert_close(tlast, jlast, dtype, "last logits")
    assert_tree_close(tcache, jcache, dtype, "cache")
    cross = {k: v.clone() for k, v in tcache["cross"].items()}
    step = jit_ref(jm.decode_step)
    rng = np.random.default_rng(3)
    for i in range(3):
        tok = rng.integers(0, tm.cfg.vocab_size, (2,)).astype(np.int32)
        jl, jcache = step(jp, jcache, jnp.asarray(tok), jnp.int32(7 + i))
        tl, tcache = tm.decode_step(tcache, torch.from_numpy(tok), 7 + i)
        assert_close(tl, jl, dtype, f"decode logits step {i}")
        assert_tree_close(tcache, jcache, dtype, f"cache step {i}")
    # the cross KV is read, never written
    assert all(torch.equal(cross[k], tcache["cross"][k]) for k in cross)


def test_init_cache_matches_jax_package():
    jm, _, tm = pair(ARCH, "bfloat16")
    want = jm.init_cache(3, 12)
    got = tm.init_cache(3, 12)
    for part in ("kv", "cross"):
        for k in ("k", "v"):
            assert tuple(got[part][k].shape) == want[part][k].shape
            assert got[part][k].dtype == torch.bfloat16
            assert not got[part][k].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_generate_matches_jax_package(dtype):
    jm, jp, tm = pair(ARCH, dtype)
    jb, tb = batches(tm.cfg, T=6)
    want = jax_generate(JittedModel(jm), jp, jb, 5)
    rec = {}
    got = generate(tm, tb, 5, record=rec)
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    tokens_agree(got, want, rec["logits"][:, :5], dtype)
    assert rec["logits"].shape == (2, 6, tm.cfg.vocab_size)
    assert len(rec["decode_ms"]) == 5


def test_decode_matches_teacher_forcing():
    """The card smoke's gate on the CPU: every step's logits from
    ``generate`` against ``logits`` of the prompt plus the generated
    tokens, in f32, within 1e-3 * max|ref| (JAX's attention-arch
    tolerance)."""
    _, _, tm = pair(ARCH, "float32")
    _, tb = batches(tm.cfg, T=6)
    rec = {}
    toks = generate(tm, tb, 4, record=rec)
    full = dict(tb, tokens=torch.cat([tb["tokens"], toks], dim=1))
    with torch.no_grad():
        ref = tm.logits(full)[:, 5:]
    err = float((rec["logits"][:, :5] - ref).abs().max())
    assert err <= 1e-3 * float(ref.abs().max())
    assert len(rec["decode_ms"]) == 4
