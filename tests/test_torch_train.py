"""The port's training path (``repro_torch.optim``, ``launch.steps.
make_train_step``, remat, ``launch.train``) against the JAX package's, on
the CPU at the smoke sizes.

The JAX weights are carried across with ``from_jax_params`` and the JAX
side is compiled as ``_zoo`` compiles it.  Tolerances: AdamW and the train
step f32, each parameter leaf within 1e-5 * max|ref| (and the moments
likewise), the loss and ``grad_norm`` rtol 1e-5; model gradients f32, the
loss rtol 1e-5 and each gradient leaf (the port's layers stacked as JAX's
leaf) within 1e-4 * max|ref|; bf16, the loss within 1e-2 * |ref|.  Remat
changes no bit on the CPU.

One gradient is zero in exact arithmetic: the sLSTM input gate's bias
shifts every step's log input gate alike, and the normalised state c / n
cancels the common factor (``ZERO_GRADS``).  Its f32 values in both
packages are rounding noise, about 1e-9, so they are held below 1e-6 of
the tree's largest gradient instead of against each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _zoo import (ZOO_ARCHS, _numpy_params, as_np, batches, configs,
                  flat_specs, jit_ref, pair, restacked)
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.optim import adamw as jax_adamw
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model
from repro_torch.models import transformer as port_transformer
from repro_torch.models.convert import state_from_jax
from repro_torch.optim import adamw

F32_LEAF = 1e-5
GRAD_LEAF = 1e-4
#: gradient leaves that are zero in exact arithmetic
ZERO_GRADS = {"blocks/slstm/p/b_i"}
NOISE = 1e-6


def assert_leaves_close(got: dict, want: dict, rel: float, what: str = ""):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        w = np.asarray(w, dtype=np.float32)
        assert got[k].shape == w.shape, (what, k)
        err = float(np.abs(got[k] - w).max())
        assert err <= rel * max(float(np.abs(w).max()), 1e-30), \
            (what, k, err)


def jax_flat(tree) -> dict:
    return {k: as_np(v) for k, v in flat_specs(tree)}


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #


def seeded_grads(tree: dict, seed: int) -> dict:
    """A gradient tree of ``tree``'s shapes whose global norm is well above
    the clip norm of 1."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.normal(0.0, 3.0, np.shape(a)).astype(np.float32), tree)


def test_adamw_matches_the_jax_package_over_three_clipped_steps():
    tree = _numpy_params("qwen2-7b", ())         # stacked layers, biases
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jax_adamw.init_opt_state(jparams)
    params = state_from_jax(tree)
    state = adamw.init_opt_state(params)
    jupdate = jit_ref(lambda p, g, s: jax_adamw.apply_updates(
        p, g, s, jax_adamw.AdamWConfig(**cfg)))
    for step in range(3):
        g = seeded_grads(tree, step)
        jparams, jstate, jm = jupdate(jparams, jax.tree.map(jnp.asarray, g),
                                      jstate)
        _, state, m = adamw.apply_updates(params, state_from_jax(g), state,
                                          adamw.AdamWConfig(**cfg))
        assert float(jm["grad_norm"]) > 10 * cfg["lr"]   # clipping active
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(state.step) == int(jstate.step) == step + 1
        assert_leaves_close(restacked(params), jax_flat(jparams), F32_LEAF,
                            f"params {step}")
        assert_leaves_close(restacked(state.mu), jax_flat(jstate.mu),
                            F32_LEAF, f"mu {step}")
        assert_leaves_close(restacked(state.nu), jax_flat(jstate.nu),
                            F32_LEAF, f"nu {step}")


def test_adamw_updates_a_bf16_parameter_in_f32_as_the_jax_package():
    """A parameter stored in bf16 is updated in f32 and rounded back once,
    in both packages; its moments are f32."""
    rng = np.random.default_rng(4)
    w, b, gw, gb = (rng.normal(size=s).astype(np.float32)
                    for s in ((8, 8), (8,), (8, 8), (8,)))
    cfg = dict(lr=1e-2, warmup_steps=0)
    jp = {"w": jnp.asarray(w).astype(jnp.bfloat16), "b": jnp.asarray(b)}
    jnew, jstate, _ = jax_adamw.apply_updates(
        jp, {"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
        jax_adamw.init_opt_state(jp), jax_adamw.AdamWConfig(**cfg))
    tp = {"w": torch.from_numpy(w).bfloat16(), "b": torch.from_numpy(b)}
    state = adamw.init_opt_state(tp)
    adamw.apply_updates(tp, {"w": torch.from_numpy(gw),
                             "b": torch.from_numpy(gb)}, state,
                        adamw.AdamWConfig(**cfg))
    assert tp["w"].dtype == torch.bfloat16
    assert state.mu["w"].dtype == torch.float32
    np.testing.assert_array_equal(as_np(tp["w"]), as_np(jnew["w"]))
    np.testing.assert_allclose(as_np(tp["b"]), as_np(jnew["b"]), rtol=1e-6)
    np.testing.assert_allclose(as_np(state.nu["w"]), as_np(jstate.nu["w"]),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-7b", "xlstm-1.3b",
                                  "jamba-1.5-large-398b", "whisper-medium"])
def test_adamw_decays_the_leaves_the_jax_package_decays(arch):
    """With zero gradients only the weight decay moves a leaf, so the leaves
    that move are the decayed ones: JAX decides on the stacked leaf's rank,
    the port on the per-layer rank plus the stacked axes."""
    tree = _numpy_params(arch, ())
    cfg = jax_adamw.AdamWConfig(lr=1.0, warmup_steps=0)
    zeros = jax.tree.map(np.zeros_like, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    jnew, _, _ = jax_adamw.apply_updates(
        jparams, jax.tree.map(jnp.asarray, zeros),
        jax_adamw.init_opt_state(jparams), cfg)
    want = {k for k, v in flat_specs(jnew)
            if not np.array_equal(np.asarray(v), dict(flat_specs(tree))[k])}
    params = state_from_jax(tree)
    adamw.apply_updates(params, state_from_jax(zeros),
                        adamw.init_opt_state(params),
                        adamw.AdamWConfig(lr=1.0, warmup_steps=0))
    got = {k for k, v in restacked(params).items()
           if not np.array_equal(v, dict(flat_specs(tree))[k])}
    assert got == want
    assert "norm_f" not in got
    if arch == "qwen2-7b":
        assert {"layers/attn/bq", "layers/norm1", "embed"} <= got


def test_schedule_matches_the_jax_package():
    cfg = dict(lr=2.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step, value in [(0, 0.0), (5, 1.0), (10, 2.0), (55, 1.1), (100, 0.2),
                        (130, 0.2)]:
        got = float(adamw.schedule(adamw.AdamWConfig(**cfg),
                                   torch.tensor(step, dtype=torch.int32)))
        want = float(jax_adamw.schedule(jax_adamw.AdamWConfig(**cfg),
                                        jnp.int32(step)))
        assert got == pytest.approx(want, rel=1e-6)
        assert got == pytest.approx(value, rel=1e-6, abs=1e-7)


# --------------------------------------------------------------------------- #
# model gradients, every arch
# --------------------------------------------------------------------------- #


def port_value_and_grad(model, batch):
    params = dict(model.named_parameters())
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_loss_and_gradients_match_the_jax_package(arch, dtype):
    jm, jparams, tm = pair(arch, dtype)
    jb, tb = batches(jm.cfg)
    jloss, jgrads = jit_ref(jax.value_and_grad(jm.loss))(jparams, jb)
    loss, grads = port_value_and_grad(tm, tb)
    if dtype == "bfloat16":
        assert abs(float(loss) - float(jloss)) <= 1e-2 * abs(float(jloss))
        return
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got, want = restacked(grads), jax_flat(jgrads)
    top = max(float(np.abs(w).max()) for w in want.values())
    noise = {k for k, w in want.items() if np.abs(w).max() < NOISE * top}
    assert noise <= ZERO_GRADS
    for k in noise:
        assert np.abs(got.pop(k)).max() < NOISE * top, k
        del want[k]
    assert_leaves_close(got, want, GRAD_LEAF, arch)


# --------------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------------- #


def lm_batch(cfg, B: int, T: int, step: int) -> tuple[dict, dict]:
    toks = JaxSyntheticLM(JaxDataConfig(seed=3, global_batch=B, seq_len=T),
                          cfg.vocab_size).batch(step)["tokens"]
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-7b"])
def test_two_train_steps_match_the_jax_package(arch, grad_accum):
    """The step's AdamW takes eps 1e-3: each element's update is then
    Lipschitz in its gradient (at most |dg| / eps apart), where with
    eps 1e-8 the first step, g / (|g| + eps), turns the f32 rounding of a
    near-zero gradient into an update up to 2 lr apart."""
    jcfg, tcfg = configs(arch, "float32")
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    tree = _numpy_params(arch, ())
    jmodel, jstep = jax_make_train_step(
        jcfg, jax_adamw.AdamWConfig(**opt), grad_accum)
    jstep = jit_ref(jstep)
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jax_adamw.init_opt_state(jparams)
    model, opt_state, step = make_train_step(
        tcfg, adamw.AdamWConfig(**opt), grad_accum, device="cpu")
    model.load_state_dict(state_from_jax(tree))
    for s in range(2):
        jb, tb = lm_batch(jcfg, 4, 16, s)
        jparams, jopt, jm = jstep(jparams, jopt, jb)
        m = step(tb)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key} {s}")
        assert_leaves_close(restacked(model), jax_flat(jparams), F32_LEAF,
                            f"params {s}")
        assert_leaves_close(restacked(opt_state.nu), jax_flat(jopt.nu),
                            F32_LEAF, f"nu {s}")
    assert int(opt_state.step) == 2


# --------------------------------------------------------------------------- #
# remat
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-medium", "xlstm-1.3b",
                                  "jamba-1.5-large-398b"])
def test_remat_changes_no_bit_and_runs_a_checkpoint_a_block(arch,
                                                            monkeypatch):
    _, plain = configs(arch, "float32")
    model = pair(arch, "float32")[2]
    remat = build_model(plain.scaled(remat=True), device="cpu")
    remat.load_state_dict(model.state_dict())
    calls = []
    real = port_transformer.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(port_transformer, "checkpoint", counting)
    _, tb = batches(plain)
    loss, grads = port_value_and_grad(model, tb)
    assert calls == []
    r_loss, r_grads = port_value_and_grad(remat, tb)
    blocks = plain.n_layers + plain.encoder_layers       # one a layer
    if plain.family in ("ssm", "hybrid"):                 # one a macro-block
        blocks //= plain.slstm_period or plain.attn_period
    assert calls == [False] * blocks
    assert torch.equal(loss, r_loss)
    assert all(torch.equal(grads[n], r_grads[n]) for n in grads)
    with torch.no_grad():               # no backward: no checkpoint
        remat.loss(tb)
    assert len(calls) == blocks


# --------------------------------------------------------------------------- #
# the driver
# --------------------------------------------------------------------------- #


def test_train_driver_loss_decreases(tmp_path):
    losses = train_main(["--arch", "olmo-1b", "--smoke", "--steps", "25",
                         "--batch", "8", "--seq", "64", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 25
    assert losses[-1] < losses[0] - 0.3
