"""The port's decoder LMs (dense, MoE, VLM, xLSTM and the Jamba hybrid:
``repro_torch.models``) against the JAX package's, on the CPU, on every
decoder arch's smoke config.

The JAX weights are carried across with ``from_jax_params``; inputs and
tolerances are ``_zoo``'s (f32 rtol = atol = 1e-5; bf16 within 1e-2 *
max|ref|).  Held: ``logits``, ``loss``, ``prefill`` (cache and last logits)
and three ``decode_step``s, in f32 and bf16; Mixtral's rolling buffer past
its window; the query-chunked path (``ATTN_CHUNK`` patched to 4 in both
packages); MoE with tokens dropped; the clamp of a full-attention decode at
``pos >= S``; ``input_specs`` of every cell; the port's own ``init``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jax_attention
from _zoo import (DECODER_ARCHS, DTYPES, ZOO_ARCHS, as_np, assert_close,
                  assert_eval_shapes_match, assert_tree_close, batches,
                  configs, flat_specs, jit_ref, pair, _numpy_params)
from repro.configs import all_cells as jax_all_cells
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.launch.steps import eval_shape_params as jax_eval_shape_params
from repro.models import SHAPES as JAX_SHAPES
from repro.models.moe import moe_aux_loss as jax_moe_aux_loss
from repro_torch.configs import (ARCHS, all_cells, cell_applicable,
                                 get_config, get_smoke_config, input_specs)
from repro_torch.dist.ctx import (activation_sharding_ctx, constrain,
                                  current_rules)
from repro_torch.launch.steps import (eval_shape_params, make_prefill_step,
                                      make_serve_step)
from repro_torch.models import SHAPES, build_model
from repro_torch.models import attention as port_attention
from repro_torch.models.convert import from_jax_params
from repro_torch.models.moe import moe_aux_loss, top_k

CASES = [(a, d) for a in DECODER_ARCHS for d in DTYPES]


def prefix_of(cfg) -> int:
    return cfg.frontend_tokens if cfg.family == "vlm" else 0


@pytest.mark.parametrize("arch,dtype", CASES)
def test_logits_match_jax_package(arch, dtype):
    jm, jp, tm = pair(arch, dtype)
    jb, tb = batches(tm.cfg)
    want = jit_ref(jm.logits)(jp, jb)
    with torch.no_grad():
        got = tm.logits(tb)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype, "logits")


@pytest.mark.parametrize("arch,dtype", CASES)
def test_loss_matches_jax_package(arch, dtype):
    jm, jp, tm = pair(arch, dtype)
    jb, tb = batches(tm.cfg)
    want = float(jit_ref(jm.loss)(jp, jb))
    with torch.no_grad():
        got = float(tm.loss(tb))
    rel = 1e-5 if dtype == "float32" else 1e-2
    assert abs(got - want) <= rel * abs(want)


def prefill_pair(arch, dtype, T=7, max_len=10, B=2, **over):
    jm, jp, tm = pair(arch, dtype, **over)
    jb, tb = batches(tm.cfg, B=B, T=T)
    cfg = tm.cfg
    jcache, jlast = jit_ref(jm.prefill, static_argnames="max_len")(
        jp, jb, max_len=prefix_of(cfg) + max_len)
    tcache, tlast = tm.prefill(tb, max_len=prefix_of(cfg) + max_len)
    return jm, jp, tm, (jcache, jlast), (tcache, tlast)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_matches_jax_package(arch, dtype):
    *_, (jcache, jlast), (tcache, tlast) = prefill_pair(arch, dtype)
    assert_close(tlast, jlast, dtype, "last logits")
    assert_tree_close(tcache, jcache, dtype, "cache")


def decode_steps(arch, dtype, T=7, max_len=10, steps=3, **over):
    """Prefill T tokens, then ``steps`` decode steps of the same seeded
    tokens in both packages; every step's logits and cache compared."""
    jm, jp, tm, (jcache, _), (tcache, _) = prefill_pair(
        arch, dtype, T=T, max_len=max_len, **over)
    step = jit_ref(jm.decode_step)
    rng = np.random.default_rng(3)
    start = prefix_of(tm.cfg) + T
    for i in range(steps):
        tok = rng.integers(0, tm.cfg.vocab_size, (2,)).astype(np.int32)
        jl, jcache = step(jp, jcache, jnp.asarray(tok), jnp.int32(start + i))
        tl, tcache = tm.decode_step(tcache, torch.from_numpy(tok), start + i)
        assert_close(tl, jl, dtype, f"decode logits step {i}")
        assert_tree_close(tcache, jcache, dtype, f"cache step {i}")
    return tm


@pytest.mark.parametrize("arch,dtype", CASES)
def test_decode_steps_match_jax_package(arch, dtype):
    decode_steps(arch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rolling_buffer_past_the_window(dtype):
    """Mixtral's smoke window is 8: a prompt of 12 fills the rolling buffer
    (truncated, rolled by 12 % 8), and 6 decode steps wrap it again."""
    tm = decode_steps("mixtral-8x7b", dtype, T=12, max_len=20, steps=6)
    assert tm.cfg.sliding_window == 8
    assert tm.init_cache(2, 20)["kv"]["k"].shape[2] == 8


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_attention_decode_at_pos_past_the_cache_clamps(dtype):
    """``dynamic_update_slice`` clamps its start: with S = 7 slots, decodes
    at pos 7, 8 and 9 all overwrite slot 6, in both packages."""
    tm = decode_steps("qwen2-7b", dtype, T=7, max_len=7, steps=3)
    assert tm.init_cache(2, 7)["kv"]["k"].shape[2] == 7


@pytest.mark.parametrize("arch", ["qwen2-7b", "olmo-1b", "mixtral-8x7b",
                                  "llava-next-34b"])
def test_query_chunked_attention_matches_jax_package(arch, monkeypatch):
    """``ATTN_CHUNK`` patched to 4 in both packages: 8 text positions (16
    with llava's 8 patches) run as query chunks, in logits and prefill."""
    monkeypatch.setattr(jax_attention, "ATTN_CHUNK", 4)
    monkeypatch.setattr(port_attention, "ATTN_CHUNK", 4)
    blocks = []
    real = port_attention._softmax_to
    monkeypatch.setattr(port_attention, "_softmax_to",
                        lambda s, d: blocks.append(s.shape) or real(s, d))
    jm, jp, tm = pair(arch, "float32")
    jb, tb = batches(tm.cfg, T=8)
    with torch.no_grad():
        got = tm.logits(tb)
    assert_close(got, jit_ref(jm.logits)(jp, jb), "float32", "logits")
    T = 8 + prefix_of(tm.cfg)
    assert len(blocks) == tm.cfg.n_layers * T // 4
    assert all(s[2] == 4 and s[3] == T for s in blocks)
    jcache, jlast = jit_ref(jm.prefill, static_argnames="max_len")(
        jp, jb, max_len=T + 2)
    tcache, tlast = tm.prefill(tb, max_len=T + 2)
    assert_close(tlast, jlast, "float32", "last logits")
    assert_tree_close(tcache, jcache, "float32", "cache")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_with_tokens_dropped_matches_jax_package(arch, dtype):
    """capacity_factor 0.5: 16 tokens x top-2 into 4 experts of capacity
    int(0.5 * 16 * 2 / 4) = 4 — at least half the assignments dropped."""
    jm, jp, tm = pair(arch, dtype, capacity_factor=0.5)
    cfg = tm.cfg
    jb, tb = batches(cfg, B=2, T=8)
    C = max(1, int(cfg.capacity_factor * 16 * cfg.top_k / cfg.n_experts))
    assert C * cfg.n_experts < 16 * cfg.top_k
    with torch.no_grad():
        got = tm.logits(tb)
    assert_close(got, jit_ref(jm.logits)(jp, jb), dtype, "logits")
    # dropping changes the result: the default capacity gives other logits
    with torch.no_grad():
        full = pair(arch, dtype)[2].logits(tb)
    assert float((full.float() - got.float()).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"])
def test_moe_aux_loss_matches_jax_package(arch):
    jm, jp, tm = pair(arch, "float32")
    x = np.random.default_rng(4).normal(size=(2, 8, tm.cfg.d_model)
                                        ).astype(np.float32)
    p0 = jax.tree.map(lambda a: a[0], jp["layers"]["ffn"])
    want = float(jax_moe_aux_loss(p0, jnp.asarray(x), jm.cfg))
    with torch.no_grad():
        got = float(moe_aux_loss(tm.layers[0].ffn.tree(),
                                 torch.from_numpy(x), tm.cfg))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_top_k_breaks_ties_like_lax_top_k():
    rng = np.random.default_rng(5)
    probs = rng.integers(0, 3, size=(64, 8)).astype(np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax_package(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        want = jax_input_specs(jcfg, JAX_SHAPES[name])
        got = input_specs(cfg, shape)
        assert set(got) == set(want)
        for k, spec in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(spec.shape)
            assert str(got[k].dtype) == f"torch.{spec.dtype}"
    assert all_cells() == jax_all_cells()
    assert [cell_applicable(arch, s) for s in SHAPES] == \
        [s != "long_500k" or arch not in
         ("olmo-1b", "qwen2-7b", "qwen1.5-32b", "qwen2.5-32b",
          "llava-next-34b", "whisper-medium") for s in SHAPES]


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_builds_every_arch(arch):
    """Every arch of the registry at its full config, on ``meta``: the
    parameter count of the JAX package's tree."""
    cfg = get_config(arch)
    model, state = eval_shape_params(cfg)
    assert all(t.device.type == "meta" for t in state.values())
    _, jtree = jax_eval_shape_params(jax_get_config(arch))
    assert sum(t.numel() for t in state.values()) == sum(
        int(np.prod(s.shape)) for _, s in flat_specs(jtree))
    assert model.cfg.family == jax_get_config(arch).family


def test_build_model_without_a_card_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke_config("qwen2-7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params(get_smoke_config("qwen2-7b"),
                        _numpy_params("qwen2-7b", ()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serve_step(get_smoke_config("qwen2-7b"))


def leaf_stats(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaf_stats(v, f"{prefix}{k}/"))
        else:
            a = as_np(v)
            out[prefix + k] = (a.shape, str(v.dtype).replace("torch.", ""),
                               float(a.std()), float(a.mean()))
    return out


def _restack(module) -> dict:
    """A layer's tree, or a stack's (nested ``ModuleList``s) restacked on
    leading axes as the JAX tree stacks it."""
    if isinstance(module, torch.nn.ModuleList):
        return jax.tree.map(lambda *a: torch.stack(a),
                            *[_restack(m) for m in module])
    return module.tree()


def port_tree(model) -> dict:
    """The port's parameters as the JAX tree: stacks (``layers``,
    ``blocks.mlstm``, ...) restacked on their leading axes."""
    out = {}
    for name, p in model.named_parameters(recurse=False):
        out[name] = p
    for name in model.STACKS:
        *parents, leaf = name.split(".")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = _restack(model.get_submodule(name))
    return out


@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_init_draws_like_jax_package(arch):
    """The port's ``init`` (a ``torch.Generator``) draws every leaf with the
    JAX init's shape, dtype, mean and std (±10%); a leaf the JAX init
    fills without a draw (the same under two keys: zeros, ones, A_log)
    to an ulp (XLA's f32 log is not correctly rounded: log 7, 47 and 49
    are an ulp off)."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    tree = port_tree(build_model(cfg, device="cpu").init(gen))
    got = leaf_stats(tree)
    jm = configs(arch, cfg.dtype)[0]
    from repro.models import build_model as jax_build_model
    init = jax_build_model(jm).init
    jtree = init(jax.random.PRNGKey(0))
    want = leaf_stats(jtree)
    fixed = {k for (k, a), (_, b) in zip(
        flat_specs(jtree), flat_specs(init(jax.random.PRNGKey(1))))
        if np.array_equal(as_np(a), as_np(b))}
    port_leaves = dict(flat_specs(tree))
    assert set(got) == set(want)
    for k, (shape, dt, std, mean) in want.items():
        g_shape, g_dt, g_std, g_mean = got[k]
        assert (g_shape, g_dt) == (shape, dt), k
        if k in fixed:
            np.testing.assert_allclose(as_np(port_leaves[k]),
                                       as_np(dict(flat_specs(jtree))[k]),
                                       rtol=2.0 ** -23, atol=0, err_msg=k)
        else:
            assert abs(g_std - std) <= 0.1 * std, (k, g_std, std)
            assert abs(g_mean) <= 0.1 * std, (k, g_mean)


def test_init_repeats_one_expert_and_follows_the_generator():
    cfg = get_smoke_config("mixtral-8x7b")
    a = build_model(cfg, "cpu").init(torch.Generator().manual_seed(7))
    b = build_model(cfg, "cpu").init(torch.Generator().manual_seed(7))
    w = a.layers[0].ffn.w_gate
    assert all(torch.equal(w[0], w[e]) for e in range(cfg.n_experts))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


def test_eval_shapes_match_jax_package():
    """Parameter and cache shapes on the ``meta`` device, at full size."""
    for arch in ("qwen2-7b", "mixtral-8x7b", "whisper-medium"):
        assert_eval_shapes_match(arch)


def test_from_jax_params_refuses_a_tree_that_does_not_fit():
    cfg = get_smoke_config("qwen2-7b")
    tree = _numpy_params("qwen2-7b", ())
    missing = dict(tree, layers={k: v for k, v in tree["layers"].items()
                                 if k != "norm1"})
    with pytest.raises(KeyError, match="norm1"):
        from_jax_params(cfg, missing, device="cpu")
    wrong = dict(tree, norm_f=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="norm_f"):
        from_jax_params(cfg, wrong, device="cpu")


def test_cast_weights_gives_the_same_values():
    _, _, tm = pair("phi3.5-moe-42b-a6.6b", "bfloat16")
    _, tb = batches(tm.cfg)
    with torch.no_grad():
        want = tm.logits(tb)
        with tm.cast_weights():
            got = tm.logits(tb)
            router = tm._layers("layers")[0]["ffn"]["router"]
    assert torch.equal(got, want)
    assert router.dtype == torch.bfloat16      # rounded, as in JAX
    assert tm._cast_once is None


def test_steps_drive_the_model():
    cfg = get_smoke_config("qwen2-7b")
    model, prefill = make_prefill_step(cfg, max_len=12, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    _, tb = batches(cfg)
    cache, last = prefill(tb)
    assert cache["kv"]["k"].shape == (cfg.n_layers, 2, 12, cfg.n_kv_heads,
                                      cfg.hd)
    serve_model, step = make_serve_step(cfg, device="cpu")
    serve_model.load_state_dict(model.state_dict())
    logits, cache2 = step(cache, last[:, 0].argmax(-1), 8)
    assert logits.shape == (2, cfg.vocab_size) and cache2 is cache


def test_constrain_is_identity_without_rules_and_raises_on_a_placement():
    x = torch.arange(8.0).reshape(2, 4)
    assert current_rules() is None
    assert constrain(x, "residual") is x
    seen = []
    with activation_sharding_ctx(lambda n, s: seen.append((n, s))):
        assert constrain(x, "heads") is x
        with activation_sharding_ctx(lambda n, s: "placed") as inner:
            assert current_rules() is inner
            with pytest.raises(NotImplementedError, match="multi-card"):
                constrain(x, "residual")
        assert constrain(x, "logits") is x
    assert current_rules() is None
    assert seen == [("heads", (2, 4)), ("logits", (2, 4))]
