"""The port's training substrate (``repro_torch.optim``, ``data``,
``checkpoint``, ``runtime``) on the CPU: the cases of
``tests/test_substrate.py`` and ``tests/test_fault_tolerance.py`` run
against the port's modules (the driver's loss test is in
``test_torch_train.py``), the data pipeline byte for byte against the JAX
package's, and checkpoints read across packages both ways.

Restart is exact to the bit.  A JAX checkpoint restores into the port to
the bit, and 3 more steps in each package give losses within rtol 1e-5
(the step's AdamW at eps 1e-3, as in ``test_torch_train.py``, which holds
the parameters after the steps); a port checkpoint restores through the
JAX package's ``Checkpointer`` to the bit.
"""
import os
import signal
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _zoo import _numpy_params, configs, flat_specs, jit_ref, restacked
from repro.checkpoint.ckpt import Checkpointer as JaxCheckpointer
from repro.checkpoint.ckpt import tree_paths as jax_tree_paths
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jax_pipeline
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint.ckpt import Checkpointer, tree_paths
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                       add_frontend_stub, host_local_batch,
                                       make_source)
from repro_torch.dist.sharding import NamedSharding, P
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.convert import state_from_jax
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     init_opt_state, schedule)
from repro_torch.runtime.fault_tolerance import (RunState, StragglerDetector,
                                                 TrainingRuntime)

CPU = torch.device("cpu")


# --------------------------------------------------------------------------- #
# optimizer (tests/test_substrate.py)
# --------------------------------------------------------------------------- #


def test_adamw_reduces_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_opt_state(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, m = apply_updates(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.3


def test_grad_clipping_bounds_update():
    cfg = AdamWConfig(lr=1.0, clip_norm=1.0, warmup_steps=0, total_steps=10)
    params = {"w": torch.zeros(4)}
    state = init_opt_state(params)
    grads = {"w": torch.full((4,), 1e6)}
    _, _, metrics = apply_updates(params, grads, state, cfg)
    assert float(metrics["grad_norm"]) > 1e5     # raw norm reported


def test_schedule_warmup_and_cosine():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    i32 = torch.int32
    assert float(schedule(cfg, torch.tensor(5, dtype=i32))) \
        == pytest.approx(0.5)
    assert float(schedule(cfg, torch.tensor(10, dtype=i32))) \
        == pytest.approx(1.0)
    assert float(schedule(cfg, torch.tensor(100, dtype=i32))) \
        == pytest.approx(0.1)


# --------------------------------------------------------------------------- #
# data pipeline
# --------------------------------------------------------------------------- #


def test_data_deterministic_per_step():
    cfg = DataConfig(seed=3, global_batch=4, seq_len=32)
    s1 = SyntheticLM(cfg, vocab_size=101)
    s2 = SyntheticLM(cfg, vocab_size=101)
    np.testing.assert_array_equal(s1.batch(7)["tokens"], s2.batch(7)["tokens"])
    assert not np.array_equal(s1.batch(7)["tokens"], s1.batch(8)["tokens"])


def test_data_in_vocab_range():
    cfg = DataConfig(seed=0, global_batch=8, seq_len=64)
    src = SyntheticLM(cfg, vocab_size=50)
    toks = src.batch(0)["tokens"]
    assert toks.min() >= 0 and toks.max() < 50
    assert toks.shape == (8, 64)


def test_token_file_source(tmp_path):
    path = tmp_path / "toks.bin"
    arr = np.arange(10_000, dtype=np.int32) % 97
    arr.tofile(path)
    cfg = DataConfig(seed=1, global_batch=4, seq_len=16, source="file",
                     path=str(path))
    src = make_source(cfg, get_smoke_config("olmo-1b"))
    b = src.batch(3)["tokens"]
    assert b.shape == (4, 16)
    np.testing.assert_array_equal(src.batch(3)["tokens"], b)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (17, 11), (5, 1000)])
def test_batches_equal_the_jax_packages_byte_for_byte(seed, step, tmp_path):
    cfg = dict(seed=seed, global_batch=4, seq_len=48)
    for vocab in (101, 50304):
        got = SyntheticLM(DataConfig(**cfg), vocab).batch(step)["tokens"]
        want = jax_pipeline.SyntheticLM(jax_pipeline.DataConfig(**cfg),
                                        vocab).batch(step)["tokens"]
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    path = tmp_path / "toks.bin"
    (np.arange(5_000, dtype=np.int32) * 7 % 1013).tofile(path)
    fcfg = dict(cfg, source="file", path=str(path))
    got = make_source(DataConfig(**fcfg), get_smoke_config("olmo-1b")) \
        .batch(step)["tokens"]
    want = jax_pipeline.make_source(jax_pipeline.DataConfig(**fcfg),
                                    jax_smoke_config("olmo-1b")) \
        .batch(step)["tokens"]
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,key", [("llava-next-34b", "patch_embeds"),
                                      ("whisper-medium", "audio_embeds")])
def test_frontend_stub_equals_the_jax_packages(arch, key, dtype):
    jcfg, tcfg = configs(arch, dtype)
    toks = {"tokens": np.zeros((3, 8), np.int32)}
    got = add_frontend_stub(toks, tcfg, step=4, seed=17)[key]
    want = jax_pipeline.add_frontend_stub(toks, jcfg, step=4, seed=17)[key]
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        assert want.dtype == ml_dtypes.bfloat16
        assert got.view(torch.int16).numpy().tobytes() \
            == want.view(np.int16).tobytes()
    else:
        assert got.numpy().tobytes() == want.tobytes()
    assert add_frontend_stub(toks, get_smoke_config("olmo-1b"), 4) is toks


def test_host_local_batch_places_on_the_mesh_device():
    mesh = make_host_mesh(device_type="cpu")
    sh = {"tokens": NamedSharding(mesh, P("data", None))}
    out = host_local_batch({"tokens": np.arange(6, dtype=np.int32)
                            .reshape(2, 3)}, mesh, sh)
    assert isinstance(out["tokens"], torch.Tensor)
    assert out["tokens"].device == CPU and out["tokens"].dtype == torch.int32


# --------------------------------------------------------------------------- #
# checkpointing
# --------------------------------------------------------------------------- #


def make_tree(x=1.0):
    return {"a": torch.full((4, 4), x), "b": {"c": torch.arange(3) * 0
                                             + int(x)}}


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = make_tree(2.0)
    ck.save(10, tree)
    assert ck.latest_step() == 10
    target = make_tree(0.0)
    restored, step = ck.restore(10, target)
    assert step == 10
    np.testing.assert_allclose(restored["a"], np.full((4, 4), 2.0))
    assert restored["a"] is target["a"]               # filled in place
    np.testing.assert_array_equal(restored["b"]["c"], [2, 2, 2])


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, make_tree(float(s)), blocking=False)
    ck.wait()
    ck._gc()
    assert ck.committed_steps() == [3, 4]


def test_checkpoint_atomic_commit_marker(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, make_tree())
    assert os.path.exists(tmp_path / "step_5.COMMITTED")
    # uncommitted junk is invisible
    os.makedirs(tmp_path / "step_99", exist_ok=True)
    assert ck.latest_step() == 5


def test_checkpoint_reshard_on_restore(tmp_path):
    """Elastic restore: a host leaf comes back on the placement's device."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": np.ones((8, 4), np.float32)})
    mesh = make_mesh((1,), ("data",), [CPU])
    sh = {"w": NamedSharding(mesh, P(None, None))}
    restored, _ = ck.restore(1, {"w": np.zeros((8, 4), np.float32)},
                             shardings=sh)
    assert isinstance(restored["w"], torch.Tensor)
    assert restored["w"].device == sh["w"].device
    assert torch.equal(restored["w"], torch.ones(8, 4))


def test_checkpoint_refuses_a_template_of_other_leaves(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="lacks"):
        ck.restore(1, {"v": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, {"w": torch.ones(3)})


def test_async_save_writes_the_values_of_its_step(tmp_path, monkeypatch):
    """The trainer saves asynchronously and its next step updates the
    carry's tensors in place (AdamW, the step counter) while the writer
    runs: the checkpoint of step 2 holds step 2's values, equal to the bit
    to a blocking save's of the same run.  The writer is held until step 3
    has updated the carry."""
    from repro_torch.checkpoint import ckpt as ckpt_module
    from repro_torch.launch.train import build_trainer
    stepped = threading.Event()
    savez = np.savez

    def late_savez(*args, **kwargs):
        assert stepped.wait(60)
        savez(*args, **kwargs)

    cfg = get_smoke_config("olmo-1b")
    source = make_source(DataConfig(seed=3, global_batch=2, seq_len=16), cfg)
    saved = {}
    for mode in ("blocking", "async"):
        model, init_state, step, _ = build_trainer(
            cfg, AdamWConfig(warmup_steps=1), make_host_mesh(device_type="cpu"),
            device="cpu")
        carry = init_state(torch.Generator().manual_seed(0))
        rt = TrainingRuntime(Checkpointer(str(tmp_path / mode)), save_every=2,
                             async_save=mode == "async")
        if mode == "async":
            stepped.clear()
            monkeypatch.setattr(ckpt_module.np, "savez", late_savez)
        rt.run(carry, step, source.batch, 4,
               on_metrics=lambda s, *_: s == 2 and stepped.set())
        rt.ckpt.wait()
        with np.load(tmp_path / mode / "step_2" / "shard_0.npz") as data:
            saved[mode] = {k: data[k] for k in data.files}
    assert stepped.is_set()
    assert saved["async"].keys() == saved["blocking"].keys()
    for k, want in saved["blocking"].items():
        assert np.array_equal(saved["async"][k], want), k


# --------------------------------------------------------------------------- #
# runtime: straggler detection + restart (tests/test_substrate.py)
# --------------------------------------------------------------------------- #


def test_straggler_detector():
    d = StragglerDetector(alpha=0.5, threshold=2.0)
    assert not d.observe(0, 1.0)
    assert not d.observe(1, 1.1)
    assert d.observe(2, 10.0)
    assert d.slow_steps[0][0] == 2


def test_runtime_restart_is_exact(tmp_path):
    """Crash mid-run, restore, and land on the exact same final state."""
    ckpt_a = Checkpointer(str(tmp_path / "a"))
    ckpt_b = Checkpointer(str(tmp_path / "b"))

    def step_fn(carry, batch):
        new = {k: x + batch["tokens"].sum() for k, x in carry.items()}
        return new, {"loss": torch.zeros(())}

    def batch_fn(s):
        rng = np.random.default_rng(s)
        return {"tokens": torch.from_numpy(rng.integers(0, 5, size=(2, 2)))}

    init = {"w": torch.zeros((), dtype=torch.float64)}

    # uninterrupted reference
    rt = TrainingRuntime(ckpt_a, save_every=3, async_save=False)
    ref = rt.run(init, step_fn, batch_fn, 10)

    # crash at step 7, restart from checkpoint
    rt1 = TrainingRuntime(ckpt_b, save_every=3, async_save=False)
    with pytest.raises(RuntimeError):
        rt1.run(init, step_fn, batch_fn, 10, inject_fault_at=7)
    rt2 = TrainingRuntime(ckpt_b, save_every=3, async_save=False)
    restored = rt2.try_restore({"w": torch.zeros((), dtype=torch.float64)})
    assert restored is not None
    carry, step = restored
    assert step == 6
    out = rt2.run(carry, step_fn, batch_fn, 10)
    assert torch.equal(out["w"], ref["w"])


# --------------------------------------------------------------------------- #
# StragglerDetector (tests/test_fault_tolerance.py)
# --------------------------------------------------------------------------- #


def test_straggler_first_observation_seeds_ewma():
    det = StragglerDetector()
    assert det.observe(0, 0.5) is False
    assert det.ewma == 0.5
    assert det.slow_steps == []


def test_straggler_flags_spike_above_threshold():
    det = StragglerDetector(alpha=0.2, threshold=2.0)
    det.observe(0, 1.0)
    assert det.observe(1, 1.1) is False            # within 2x EWMA
    assert det.observe(2, 5.0) is True             # 5x the baseline
    (step, dt, ewma), = det.slow_steps
    assert step == 2 and dt == 5.0
    assert dt > det.threshold * ewma


def test_straggler_ewma_update_rule():
    det = StragglerDetector(alpha=0.25, threshold=10.0)
    det.observe(0, 1.0)
    det.observe(1, 2.0)
    assert det.ewma == pytest.approx(0.75 * 1.0 + 0.25 * 2.0)


def test_straggler_adapts_to_sustained_slowdown():
    det = StragglerDetector(alpha=0.5, threshold=2.0)
    det.observe(0, 1.0)
    assert det.observe(1, 3.0) is True
    assert det.observe(2, 3.0) is False


# --------------------------------------------------------------------------- #
# Training loop: checkpoint / crash / restart (tests/test_fault_tolerance.py)
# --------------------------------------------------------------------------- #


def _step_fn(carry, batch):
    params, opt = carry
    return (params + batch, opt + 1), {"loss": float(batch)}


def _batch_fn(step):
    return np.float64(step)


def _carry0():
    return (np.float64(0.0), np.int64(0))


def test_run_completes_and_commits_final_checkpoint(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    rt = TrainingRuntime(ckpt, save_every=3, async_save=False)
    carry = rt.run(_carry0(), _step_fn, _batch_fn, n_steps=7)
    assert rt.state.step == 7
    assert carry[0] == sum(range(7))
    assert ckpt.latest_step() == 7
    assert set(ckpt.committed_steps()) == {3, 6, 7}


def test_crash_restart_resumes_from_committed_step(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    rt = TrainingRuntime(ckpt, save_every=2, async_save=False)
    with pytest.raises(RuntimeError, match="injected fault at step 5"):
        rt.run(_carry0(), _step_fn, _batch_fn, n_steps=10,
               inject_fault_at=5)
    assert rt.state.crashed == 1
    assert ckpt.latest_step() == 4

    rt2 = TrainingRuntime(ckpt, save_every=2, async_save=False)
    restored = rt2.try_restore(_carry0())
    assert restored is not None
    carry, step = restored
    assert step == 4 and rt2.state.step == 4 and rt2.state.resumed == 1
    carry = rt2.run(carry, _step_fn, _batch_fn, n_steps=10)
    assert carry[0] == sum(range(10))
    assert rt2.state.step == 10


def test_try_restore_without_checkpoint_returns_none(tmp_path):
    rt = TrainingRuntime(Checkpointer(str(tmp_path)))
    assert rt.try_restore(_carry0()) is None
    assert rt.state.resumed == 0


def test_metrics_callback_sees_every_step(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    rt = TrainingRuntime(ckpt, save_every=100, async_save=False)
    seen = []
    rt.run(_carry0(), _step_fn, _batch_fn, n_steps=4,
           on_metrics=lambda step, m, dt, slow: seen.append(
               (step, m["loss"], slow)))
    assert [s for s, _, _ in seen] == [0, 1, 2, 3]
    assert all(not slow for _, _, slow in seen)


def test_sigterm_stops_loop_and_checkpoints(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    rt = TrainingRuntime(ckpt, save_every=1000, async_save=False)
    prev = signal.getsignal(signal.SIGTERM)
    rt.install_preemption_handler()
    try:
        def step_fn(carry, batch):
            carry, metrics = _step_fn(carry, batch)
            if batch == 3:                         # preempted mid-run
                os.kill(os.getpid(), signal.SIGTERM)
            return carry, metrics

        carry = rt.run(_carry0(), step_fn, _batch_fn, n_steps=100)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert rt.state.preempted is True
    assert rt.state.step == 4
    assert carry[0] == sum(range(4))
    assert ckpt.latest_step() == 4
    tree, step = ckpt.restore(4, _carry0())
    assert step == 4 and tree[0] == sum(range(4))


def test_elastic_restore_applies_new_shardings(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    rt = TrainingRuntime(ckpt, save_every=5, async_save=False)
    rt.run(_carry0(), _step_fn, _batch_fn, n_steps=5)

    # restore onto "whatever mesh is available" — here the CPU
    mesh = make_host_mesh(device_type="cpu")
    sharding = NamedSharding(mesh, P())
    rt2 = TrainingRuntime(ckpt, save_every=5, async_save=False)
    restored = rt2.try_restore(_carry0(), shardings=(sharding, sharding))
    assert restored is not None
    (params, opt), step = restored
    assert step == 5
    assert params.device == opt.device == CPU
    assert float(params) == sum(range(5))
    assert int(opt) == 5


def test_runstate_defaults():
    st = RunState()
    assert (st.step, st.crashed, st.resumed, st.preempted) == (0, 0, 0, False)


# --------------------------------------------------------------------------- #
# checkpoints across packages
# --------------------------------------------------------------------------- #

OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)


def lm_batch(cfg, step: int) -> np.ndarray:
    return jax_pipeline.SyntheticLM(
        jax_pipeline.DataConfig(seed=5, global_batch=4, seq_len=16),
        cfg.vocab_size).batch(step)["tokens"]


def jax_trainer(arch: str):
    jcfg, _ = configs(arch, "float32")
    _, step = jax_make_train_step(jcfg, jax_adamw.AdamWConfig(**OPT))
    params = jax.tree.map(jnp.asarray, _numpy_params(arch, ()))
    return jit_ref(step), params, jax_adamw.init_opt_state(params)


def port_trainer(arch: str):
    _, tcfg = configs(arch, "float32")
    return make_train_step(tcfg, AdamWConfig(**OPT), device="cpu")


def test_the_carry_has_the_jax_packages_leaf_paths():
    _, jparams, jopt = jax_trainer("olmo-1b")
    model, opt_state, _ = port_trainer("olmo-1b")
    paths = tree_paths((model, opt_state))
    assert paths == jax_tree_paths((jparams, jopt))
    assert len(paths) == 31
    assert paths[:2] == ["0/embed", "0/layers/attn/wk"]
    assert "1/.step" in paths and paths[-1] == "1/.nu/norm_f"


@pytest.mark.parametrize("arch", ["olmo-1b", "xlstm-1.3b"])
def test_a_jax_checkpoint_restores_into_the_port_and_trains_on(arch,
                                                               tmp_path):
    jstep, jparams, jopt = jax_trainer(arch)
    cfg = jax_smoke_config(arch)
    for s in range(2):
        jparams, jopt, _ = jstep(jparams, jopt,
                                 {"tokens": jnp.asarray(lm_batch(cfg, s))})
    JaxCheckpointer(str(tmp_path)).save(2, (jparams, jopt))

    model, opt_state, step = port_trainer(arch)
    (_, restored), at = Checkpointer(str(tmp_path)).restore(
        2, (model, opt_state))
    assert at == 2 and int(opt_state.step) == 2
    assert restored.step is opt_state.step
    for got, want in ((model, jparams), (opt_state.mu, jopt.mu),
                      (opt_state.nu, jopt.nu)):
        got = restacked(got)
        for k, w in flat_specs(want):
            assert np.array_equal(got[k], np.asarray(w)), k
    for s in range(2, 5):
        toks = lm_batch(cfg, s)
        jparams, jopt, jm = jstep(jparams, jopt, {"tokens": jnp.asarray(toks)})
        m = step({"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)


def test_a_port_checkpoint_restores_through_the_jax_package(tmp_path):
    model, opt_state, step = port_trainer("olmo-1b")
    model.load_state_dict(state_from_jax(_numpy_params("olmo-1b", ())))
    cfg = get_smoke_config("olmo-1b")
    for s in range(2):
        step({"tokens": torch.from_numpy(lm_batch(cfg, s))})
    Checkpointer(str(tmp_path)).save(2, (model, opt_state))

    _, jparams, jopt = jax_trainer("olmo-1b")
    (rparams, ropt), at = JaxCheckpointer(str(tmp_path)).restore(
        2, jax.eval_shape(lambda: (jparams, jopt)))
    assert at == 2 and int(ropt.step) == 2
    for want, got in ((model, rparams), (opt_state.mu, ropt.mu),
                      (opt_state.nu, ropt.nu)):
        want = restacked(want)
        flat = dict(flat_specs(got))
        assert set(flat) == set(want)
        for k, g in flat.items():
            assert np.array_equal(np.asarray(g), want[k]), k
