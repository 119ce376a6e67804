"""The port's Mamba and Jamba hybrid (``repro_torch.models.mamba`` and
``hybrid``) against the JAX package's, on the CPU: each module on the same
seeded numpy inputs in f32 and bf16 (the causal conv, the associative scan
and the chunked selective scan at odd, non-power-of-two and several chunk
lengths, the Mamba block and decode step, the prefill's state from a
sequence, its decay and input built a few positions at a time against
JAX's whole tensors), the MoE-FFN Mamba group (``attn_period=4``), the
short-prompt failure both packages share, ``from_jax_params`` on the Jamba
tree, ``cast_weights`` and the meta-device shapes at the published config.
Weights: ``_zoo``'s perturbed smoke tree; tolerances ``_zoo``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.hybrid as jhybrid
import repro.models.mamba as jmamba
from _zoo import (DTYPES, as_np, assert_close, assert_eval_shapes_match,
                  assert_tree_close, batches, configs, jit_ref, pair,
                  _numpy_params)
from repro_torch.models import HybridLM
from repro_torch.models import hybrid as thybrid
from repro_torch.models import mamba as tmamba
from repro_torch.models.convert import _tensor, from_jax_params

ARCH = "jamba-1.5-large-398b"
#: the MoE-FFN Mamba group runs: 2 blocks of 2 dense-FFN Mamba layers, 1
#: MoE-FFN Mamba layer and attention with a MoE FFN
MOE_GROUP = {"attn_period": 4, "n_layers": 8}


def both(a, dtype: str):
    j = jnp.asarray(a).astype(dtype)
    return j, _tensor(np.asarray(j))


def sub_params(dtype: str):
    """Dense-FFN Mamba sublayer (0, 0) of the perturbed smoke tree, every
    leaf in ``dtype`` (the layer cast), for both packages."""
    sub = jax.tree.map(lambda a: np.asarray(a)[0, 0],
                       _numpy_params(ARCH, ())["blocks"]["dense"])
    j = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), sub)
    t = jax.tree.map(lambda a: _tensor(np.asarray(a)), j)
    return j, t


def inputs(dtype: str, T: int = 8, width: int | None = None, seed: int = 0):
    cfg = configs(ARCH, dtype)
    x = np.random.default_rng(seed).normal(
        size=(2, T, width or cfg[1].d_model)).astype(np.float32)
    return cfg, both(x, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_jax_package(dtype):
    (jcfg, _), (jx_in, tx_in) = inputs(dtype, width=128)
    jp, tp = sub_params(dtype)
    m = ("conv_w", "conv_b")
    want = jit_ref(jmamba._causal_conv)(jx_in, *(jp["mamba"][k] for k in m))
    got = tmamba._causal_conv(tx_in, *(tp["mamba"][k] for k in m))
    assert_close(got, want, dtype, "causal conv")


def test_associative_scan_combines_as_lax():
    """The odd/even recursion against ``lax.associative_scan`` on the
    Mamba combine at every length 1..13, in f32 within an ulp or two (XLA
    contracts ``ib + db * ia`` into one fused multiply-add)."""
    rng = np.random.default_rng(4)
    for n in range(1, 14):
        d = rng.uniform(0.5, 1.0, (n, 3, 5)).astype(np.float32)
        i = rng.normal(size=(n, 3, 5)).astype(np.float32)

        def assoc(a, b):
            return a[0] * b[0], b[1] + b[0] * a[1]
        want = jax.jit(lambda d, i: jax.lax.associative_scan(
            assoc, (d, i), axis=0))(d, i)
        got = tmamba.associative_scan(
            tmamba._ssm_combine, [torch.from_numpy(d), torch.from_numpy(i)])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=3e-7, atol=3e-7, err_msg=str(n))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,chunk", [(7, 7), (12, 6), (15, 5)],
                         ids=["odd", "not-a-power-of-two", "three-chunks"])
def test_selective_scan_matches_jax_package(dtype, T, chunk):
    """x, dt, B, C in f32 as the block hands them over; A from the layer's
    (perturbed) A_log in ``dtype``."""
    rng = np.random.default_rng(5)
    di, ds = 16, 4
    x = rng.normal(size=(2, T, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(-2, 1, (2, T, di)))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(2, T, ds)).astype(np.float32)
              for _ in range(2))
    A_log = np.log(np.arange(1, ds + 1, dtype=np.float32))[None] \
        + rng.normal(0, 0.1, (di, ds)).astype(np.float32)
    jA, tA = both(-np.exp(A_log), dtype)
    want = jit_ref(jmamba._selective_scan, static_argnames="chunk")(
        x, dt, jA, Bm, Cm, chunk=chunk)
    got = tmamba._selective_scan(*map(torch.from_numpy, (x, dt)), tA,
                                 *map(torch.from_numpy, (Bm, Cm)), chunk)
    assert_close(got, want, dtype, "selective scan")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [256, 3])
def test_mamba_block_matches_jax_package(dtype, chunk):
    """chunk 256 at T = 8: one chunk of 8; chunk 3: the rule falls to 2,
    four chunks."""
    (jcfg, tcfg), (jx_in, tx_in) = inputs(dtype)
    jp, tp = sub_params(dtype)
    want = jit_ref(lambda p, x: jmamba.mamba_block(p, x, jcfg, chunk))(
        jp["mamba"], jx_in)
    with torch.no_grad():
        got = tmamba.mamba_block(tp["mamba"], tx_in, tcfg, chunk)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype, "mamba_block")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_step_matches_jax_package(dtype):
    """Four steps from the zero state; the port's step writes its state in
    place."""
    (jcfg, tcfg), (jx_in, tx_in) = inputs(dtype, 4)
    jp, tp = sub_params(dtype)
    jstep = jit_ref(lambda x, s: jmamba.mamba_decode_step(jp["mamba"], x, s,
                                                          jcfg))
    jst = jmamba.init_mamba_state(jcfg, 2, jnp.dtype(dtype))
    tst = tmamba.init_mamba_state(tcfg, 2, getattr(torch, dtype))
    for t in range(4):
        jo, jst = jstep(jx_in[:, t:t + 1], jst)
        with torch.no_grad():
            to, tst = tmamba.mamba_decode_step(tp["mamba"],
                                               tx_in[:, t:t + 1], tst, tcfg)
        assert_close(to, jo, dtype, f"decode out {t}")
        assert_tree_close(tst, jst, dtype, f"state {t}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [64, 3])
def test_mamba_state_from_seq_matches_jax_package(dtype, chunk):
    """The final SSM state and the conv tail after 8 positions: decay and
    input built whole (64) or three positions at a time (3, 3, 2) against
    the JAX package's whole (B, T, di, ds) tensors."""
    (jcfg, tcfg), (jx_in, tx_in) = inputs(dtype)
    jp, tp = sub_params(dtype)
    want = jit_ref(lambda p, x: jhybrid._mamba_state_from_seq(p, x, jcfg))(
        jp, jx_in)
    with torch.no_grad():
        got = thybrid._mamba_state_from_seq(tp, tx_in, tcfg, chunk=chunk)
    assert_tree_close(got, want, dtype, "state")
    if chunk == 3:     # the chunked recurrence is elementwise: same bits
        with torch.no_grad():
            whole = thybrid._mamba_state_from_seq(tp, tx_in, tcfg, chunk=8)
        assert torch.equal(got["h"], whole["h"])


def decode_run(dtype, T=7, steps=3, **over):
    """Prefill T tokens, then ``steps`` decode steps in both packages; the
    logits and caches of every step compared."""
    jm, jp, tm = pair(ARCH, dtype, **over)
    jb, tb = batches(tm.cfg, T=T)
    want = jit_ref(jm.logits)(jp, jb)
    with torch.no_grad():
        assert_close(tm.logits(tb), want, dtype, "logits")
    jcache, jlast = jit_ref(jm.prefill, static_argnames="max_len")(
        jp, jb, max_len=T + steps)
    tcache, tlast = tm.prefill(tb, max_len=T + steps)
    assert_close(tlast, jlast, dtype, "last logits")
    assert_tree_close(tcache, jcache, dtype, "cache")
    step = jit_ref(jm.decode_step)
    rng = np.random.default_rng(3)
    for i in range(steps):
        tok = rng.integers(0, tm.cfg.vocab_size, (2,)).astype(np.int32)
        jl, jcache = step(jp, jcache, jnp.asarray(tok), jnp.int32(T + i))
        tl, tcache = tm.decode_step(tcache, torch.from_numpy(tok), T + i)
        assert_close(tl, jl, dtype, f"decode logits step {i}")
        assert_tree_close(tcache, jcache, dtype, f"cache step {i}")
    return tm, tcache


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_mamba_group_matches_jax_package(dtype):
    """``attn_period=4, n_layers=8``: each of the 2 blocks runs 2
    dense-FFN Mamba layers, 1 MoE-FFN Mamba layer, then attention with a
    MoE FFN, in the JAX package's order."""
    tm, cache = decode_run(dtype, **MOE_GROUP)
    assert (tm.nb, tm.n_dense_mamba, tm.n_moe_mamba) == (2, 2, 1)
    assert tm.STACKS == ("blocks.dense", "blocks.moe", "blocks.attn")
    assert tuple(cache["moe"]["h"].shape[:3]) == (2, 1, 2)


def test_short_prompt_breaks_decode_in_both_packages():
    """A prompt shorter than d_conv - 1 = 3 leaves a conv tail of T rows:
    the first decode step raises in both packages."""
    jm, jp, tm = pair(ARCH, "float32")
    jb, tb = batches(tm.cfg, T=2)
    jcache, _ = jit_ref(jm.prefill, static_argnames="max_len")(
        jp, jb, max_len=4)
    tcache, _ = tm.prefill(tb, max_len=4)
    assert tuple(tcache["dense"]["conv"].shape[-2:]) == (2, 2 * 64) \
        == tuple(jcache["dense"]["conv"].shape[-2:])
    tok = np.zeros(2, np.int32)
    with pytest.raises(ValueError, match="does not match"):
        jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(2))
    with pytest.raises(RuntimeError):
        tm.decode_step(tcache, torch.from_numpy(tok), 2)


def test_from_jax_params_carries_the_jamba_tree():
    """Leaf (b, j) of ``blocks/dense`` and ``blocks/moe`` lands in
    ``blocks.<group>.<b>.<j>``, leaf b of ``blocks/attn`` in
    ``blocks.attn.<b>``; a tree that does not fit is refused."""
    over = tuple(sorted(MOE_GROUP.items()))
    tree = _numpy_params(ARCH, over)
    cfg = configs(ARCH, "float32", **MOE_GROUP)[1]
    model = from_jax_params(cfg, tree, device="cpu")
    assert isinstance(model, HybridLM)
    blocks = tree["blocks"]
    for b in range(model.nb):
        for g, n in (("dense", 2), ("moe", 1)):
            for j in range(n):
                layer = model.blocks[g][b][j]
                assert np.array_equal(as_np(layer.mamba.A_log),
                                      blocks[g]["mamba"]["A_log"][b, j])
                assert np.array_equal(as_np(layer.ffn.w_up),
                                      blocks[g]["ffn"]["w_up"][b, j])
        assert np.array_equal(as_np(model.blocks["attn"][b].ffn.router),
                              blocks["attn"]["ffn"]["router"][b])
    dense = dict(blocks["dense"], mamba={
        k: v for k, v in blocks["dense"]["mamba"].items() if k != "D_skip"})
    with pytest.raises(KeyError, match="D_skip"):
        from_jax_params(cfg, dict(tree, blocks=dict(blocks, dense=dense)),
                        device="cpu")
    moe = dict(blocks["moe"], norm2=np.ones((2, 1, 3), np.float32))
    with pytest.raises(ValueError, match="moe.0.0.norm2"):
        from_jax_params(cfg, dict(tree, blocks=dict(blocks, moe=moe)),
                        device="cpu")


def test_cast_weights_gives_the_same_values():
    _, _, tm = pair(ARCH, "bfloat16", **MOE_GROUP)
    _, tb = batches(tm.cfg)
    with torch.no_grad():
        want = tm.logits(tb)
        with tm.cast_weights():
            got = tm.logits(tb)
            cast = tm._layers("blocks.moe")
    assert torch.equal(got, want)
    assert cast[1][0]["mamba"]["A_log"].dtype == torch.bfloat16
    assert cast[1][0]["ffn"]["router"].dtype == torch.bfloat16
    assert tm._cast_once is None


def test_published_config_shapes_match_jax_package():
    """72 layers, d 8192, 16 experts, attn_period 8, on ``meta``: 9 blocks
    of 4 dense-FFN and 3 MoE-FFN Mamba layers and attention with a MoE
    FFN, every parameter and cache leaf against the JAX package's."""
    assert_eval_shapes_match(ARCH)
