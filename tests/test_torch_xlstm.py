"""The port's xLSTM (``repro_torch.models.xlstm`` and ``xlstm_lm``) against
the JAX package's, on the CPU: each module on the same seeded numpy inputs
in f32 and bf16 (the chunkwise mLSTM scan with its carry crossing chunks,
the mLSTM and sLSTM blocks and decode steps), the chunk rule at a prime T,
``from_jax_params`` on the xLSTM tree, ``cast_weights`` and the meta-device
shapes at the published config.  Weights: one layer of ``_zoo``'s perturbed
smoke tree; tolerances ``_zoo``'s (f32 rtol = atol = 1e-5, bf16 1e-2 *
max|ref|).  At the published width cut to 8 layers, the bf16 decode's
distance from teacher forcing in each package.  The model-level tests
(logits, loss, prefill, decode, greedy generate) are ``test_torch_models.py``'s and ``test_torch_serve.py``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.xlstm as jx
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from _zoo import (DTYPES, as_np, assert_close, assert_eval_shapes_match,
                  assert_tree_close, batches, configs, jit_ref, pair,
                  _numpy_params)
from repro_torch.configs import get_config
from repro_torch.models import XLSTMLM, build_model
from repro_torch.models import xlstm as tx
from repro_torch.models.convert import _tensor, from_jax_params
from repro_torch.models.layers import divisor_chunk

ARCH = "xlstm-1.3b"


def both(a: np.ndarray, dtype: str):
    """(JAX array, torch tensor) of ``a`` in ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    return j, _tensor(np.asarray(j))


def layer_params(kind: str, dtype: str):
    """One layer's parameters of the perturbed smoke tree, every leaf in
    ``dtype`` (the layer cast of the JAX package), for both packages."""
    tree = _numpy_params(ARCH, ())["blocks"][kind]["p"]
    index = (0, 0) if kind == "mlstm" else (0,)
    pairs = {k: both(np.asarray(v)[index], dtype) for k, v in tree.items()}
    return ({k: j for k, (j, _) in pairs.items()},
            {k: t for k, (_, t) in pairs.items()})


def inputs(dtype: str, T: int = 8, seed: int = 0):
    cfg = configs(ARCH, dtype)
    x = np.random.default_rng(seed).normal(
        size=(2, T, cfg[1].d_model)).astype(np.float32)
    return cfg, both(x, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_chunk_scan_carries_across_chunks(dtype):
    """T = 12 in chunks of 4: the (C, n, m) carry crosses two chunk
    boundaries; forget gates open (log sigmoid of N(3, 1))."""
    rng = np.random.default_rng(1)
    B, H, T, dk = 2, 2, 12, 16
    q, k, v = (both(rng.normal(size=(B, H, T, dk)).astype(np.float32),
                    dtype) for _ in range(3))
    gi = rng.normal(size=(B, H, T)).astype(np.float32)
    gf = rng.normal(3.0, 1.0, size=(B, H, T)).astype(np.float32)
    log_i = jax.nn.log_sigmoid(jnp.asarray(gi))
    log_f = jax.nn.log_sigmoid(jnp.asarray(gf))
    want = jit_ref(jx._mlstm_chunk_scan, static_argnames="chunk")(
        q[0], k[0], v[0], log_i, log_f, chunk=4)
    got = tx._mlstm_chunk_scan(q[1], k[1], v[1],
                               torch.from_numpy(np.asarray(log_i)),
                               torch.from_numpy(np.asarray(log_f)), 4)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype, "chunk scan")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_block_matches_jax_package(dtype):
    """The default chunk of 64 at T = 8: one chunk."""
    (jcfg, tcfg), (jx_in, tx_in) = inputs(dtype)
    jp, tp = layer_params("mlstm", dtype)
    want = jit_ref(lambda p, x: jx.mlstm_block(p, x, jcfg))(jp, jx_in)
    with torch.no_grad():
        got = tx.mlstm_block(tp, tx_in, tcfg)
    assert_close(got, want, dtype, "mlstm_block")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,chunks", [(12, 3), (7, 7)])
def test_mlstm_block_in_several_chunks_matches_jax_package(dtype, T, chunks):
    """chunk = 4: three chunks at T = 12; at T = 7, a prime above the
    chunk, the rule falls to chunks of 1 in both packages."""
    (jcfg, tcfg), (jx_in, tx_in) = inputs(dtype, T)
    jp, tp = layer_params("mlstm", dtype)
    want = jit_ref(lambda p, x: jx.mlstm_block(p, x, jcfg, chunk=4))(
        jp, jx_in)
    with torch.no_grad():
        got = tx.mlstm_block(tp, tx_in, tcfg, chunk=4)
    assert_close(got, want, dtype, "mlstm_block chunk 4")
    assert T // divisor_chunk(T, 4) == chunks


def step_through(jstep, tstep, jstate, tstate, xs_j, xs_t, dtype, what):
    """Both packages' decode steps over the positions of xs; each step's
    output and state compared.  The port's step writes its state in place:
    it gets its own tensors."""
    for t in range(xs_j.shape[1]):
        jo, jstate = jstep(xs_j[:, t:t + 1], jstate)
        to, tstate = tstep(xs_t[:, t:t + 1], tstate)
        assert_close(to, jo, dtype, f"{what} out {t}")
        assert_tree_close(tstate, jstate, dtype, f"{what} state {t}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_decode_step_matches_jax_package(dtype):
    (jcfg, tcfg), (jx_in, tx_in) = inputs(dtype, 4)
    jp, tp = layer_params("mlstm", dtype)
    jstep = jit_ref(lambda x, s: jx.mlstm_decode_step(jp, x, s, jcfg))
    with torch.no_grad():
        step_through(jstep,
                     lambda x, s: tx.mlstm_decode_step(tp, x, s, tcfg),
                     jx.init_mlstm_state(jcfg, 2, jnp.float32),
                     tx.init_mlstm_state(tcfg, 2), jx_in, tx_in, dtype,
                     "mlstm decode")


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_block_matches_jax_package(dtype):
    (jcfg, tcfg), (jx_in, tx_in) = inputs(dtype)
    jp, tp = layer_params("slstm", dtype)
    want = jit_ref(lambda p, x: jx.slstm_block(p, x, jcfg))(jp, jx_in)
    with torch.no_grad():
        got = tx.slstm_block(tp, tx_in, tcfg)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype, "slstm_block")


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_decode_step_matches_jax_package(dtype):
    (jcfg, tcfg), (jx_in, tx_in) = inputs(dtype, 4)
    jp, tp = layer_params("slstm", dtype)
    jstep = jit_ref(lambda x, s: jx.slstm_decode_step(jp, x, s, jcfg))
    with torch.no_grad():
        step_through(jstep,
                     lambda x, s: tx.slstm_decode_step(tp, x, s, tcfg),
                     jx.init_slstm_state(jcfg, 2, jnp.float32),
                     tx.init_slstm_state(tcfg, 2), jx_in, tx_in, dtype,
                     "slstm decode")


def test_from_jax_params_carries_the_xlstm_tree():
    """Leaf (b, j) of ``blocks/mlstm`` lands in ``blocks.mlstm.<b>.<j>``,
    leaf b of ``blocks/slstm`` in ``blocks.slstm.<b>``; a tree that does
    not fit is refused."""
    tree = _numpy_params(ARCH, ())
    cfg = configs(ARCH, "float32")[1]
    model = from_jax_params(cfg, tree, device="cpu")
    assert isinstance(model, XLSTMLM) and model.nb == 2 and model.nm == 1
    m = tree["blocks"]["mlstm"]
    for b in range(model.nb):
        for j in range(model.nm):
            got = model.blocks["mlstm"][b][j]
            assert np.array_equal(got.p.wq.detach().numpy(),
                                  m["p"]["wq"][b, j])
            assert np.array_equal(got.norm.detach().numpy(), m["norm"][b, j])
        assert np.array_equal(model.blocks["slstm"][b].p.r_z.detach().numpy(),
                              tree["blocks"]["slstm"]["p"]["r_z"][b])
    mlstm = dict(m, p={k: v for k, v in m["p"].items() if k != "b_f"})
    short = dict(tree, blocks=dict(tree["blocks"], mlstm=mlstm))
    with pytest.raises(KeyError, match="b_f"):
        from_jax_params(cfg, short, device="cpu")
    slstm = tree["blocks"]["slstm"]
    wrong = dict(tree, blocks=dict(tree["blocks"], slstm=dict(
        slstm, norm=np.ones((2, 3), np.float32))))
    with pytest.raises(ValueError, match="slstm.0.norm"):
        from_jax_params(cfg, wrong, device="cpu")


def test_cast_weights_gives_the_same_values():
    _, _, tm = pair(ARCH, "bfloat16")
    _, tb = batches(tm.cfg)
    with torch.no_grad():
        want = tm.logits(tb)
        with tm.cast_weights():
            got = tm.logits(tb)
            cast = tm._layers("blocks.mlstm")
    assert torch.equal(got, want)
    assert len(cast) == tm.nb and len(cast[0]) == tm.nm
    assert cast[0][0]["p"]["b_f"].dtype == torch.bfloat16   # as in JAX
    assert tm._cast_once is None


def test_published_config_shapes_match_jax_package():
    """48 layers, d 2048, 4 heads, 7:1, on ``meta``: every parameter and
    cache leaf (the recurrent state: 2.8 GB at B = 4 in f32) against the
    JAX package's ``eval_shape``."""
    assert_eval_shapes_match(ARCH)
    cache = build_model(get_config(ARCH), "meta").init_cache(4, 16)
    assert tuple(cache["mlstm"]["C"].shape) == (6, 7, 4, 4, 1024, 1024)
    assert cache["mlstm"]["C"].dtype == torch.float32


def decode_against_teacher(prefill, decode_step, logits, toks, T: int):
    """Max |decode - teacher| / max |teacher| over the new positions: the
    prompt ``toks[:, :T]`` prefilled, then one decode step a later token
    of ``toks`` (fed, not sampled), against ``logits`` of all of ``toks``
    from position T - 1 on."""
    new = toks.shape[1] - T
    cache, lg = prefill(toks[:, :T], T + new)
    got = [as_np(lg[:, -1])]
    for i in range(new):
        lg, cache = decode_step(cache, toks[:, T + i], T + i)
        got.append(as_np(lg))
    got, want = np.stack(got, 1), as_np(logits(toks))[:, T - 1:]
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_bf16_decode_leaves_its_teacher_as_the_jax_package_does():
    """The published width (d 2048, 4 heads, proj factor 2, vocab 50304)
    cut to its first macro-block (7 mLSTM blocks, 1 sLSTM), the JAX init's
    weights: in bf16 the recurrent decode leaves the chunkwise teacher by
    4.4e-2 of max |teacher| in the JAX package itself, near the card
    smoke's 5e-2, which therefore gates bf16 decode at 4 layers.  The
    port's distance is held to within a quarter of the JAX package's, so
    the drift belongs to the model and not to the port."""
    T, new = 8, 8
    jcfg = jax_get_config(ARCH).scaled(n_layers=8, dtype="bfloat16")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (1, T + new)).astype(np.int32)
    jpre = jit_ref(jm.prefill, static_argnames="max_len")
    jstep, jlogits = jit_ref(jm.decode_step), jit_ref(jm.logits)
    want = decode_against_teacher(
        lambda t, n: jpre(jp, {"tokens": jnp.asarray(t)}, max_len=n),
        lambda c, t, p: jstep(jp, c, jnp.asarray(t), jnp.int32(p)),
        lambda t: jlogits(jp, {"tokens": jnp.asarray(t)}), toks, T)
    tm = from_jax_params(get_config(ARCH).scaled(n_layers=8,
                                                 dtype="bfloat16"),
                         jax.tree.map(np.asarray, jp), device="cpu")
    del jp
    tt = torch.from_numpy(toks)
    with torch.no_grad(), tm.cast_weights():
        got = decode_against_teacher(
            lambda t, n: tm.prefill({"tokens": t}, max_len=n),
            tm.decode_step, lambda t: tm.logits({"tokens": t}), tt, T)
    assert abs(got - want) <= 0.25 * want, (got, want)
