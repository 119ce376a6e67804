"""The port's placement across devices (``repro_torch.dist``: DTensor
placements on a ``DeviceMesh``; ``launch.train`` on a process group), on
the CPU.

Every multi-rank case runs in a process of its own
(``tests/_torch_dist_worker.py``: four ranks joined by ``gloo``), since a
process group is per-process state and this one has imported JAX.
  * ``constrain``: ``tests/test_dist_ctx.py``'s cases on a (2, 2) mesh; a
    placement of extent above 1 redistributes and keeps the values.
  * the placed train step on the (2, 2), (4, 1) and (1, 4) meshes for
    olmo-1b's, mixtral-8x7b's and jamba-1.5-large's f32 smoke configs, 2
    steps, against the one-process trainer on the same seed: loss and
    grad norm within rtol 1e-5, every gathered parameter within
    1e-6 max|leaf| + 1e-5 lr.
  * the CLI under ``torch.distributed.run`` on four ranks: a fault at step
    6, then ``--resume`` from step 4, its losses the uninterrupted
    four-rank run's to the bit, its first and last loss the one-process
    run's within ``CLI_RTOL`` (bf16); its checkpoint
    (written on (2, 2)) restored on (4, 1) and in one process equal to the
    bit, and read by the JAX package's ``restore`` equal to the bit.
Each spec entry that names several axes names them in mesh order, the
order in which DTensor cuts a dimension over several mesh dimensions.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from _zoo import flat_specs, restacked
from repro.checkpoint.ckpt import Checkpointer as JaxCheckpointer
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.steps import eval_shape_params as jax_eval_shape_params
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs import input_specs
from repro_torch.dist.sharding import (batch_spec, cache_shardings,
                                       make_activation_rules,
                                       param_shardings)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import eval_shape_cache, eval_shape_params
from repro_torch.launch.train import build_trainer
from repro_torch.launch.train import main as train_main
from repro_torch.models import SHAPES
from repro_torch.optim.adamw import AdamWConfig

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(worker.__file__)
TRAIN_ARCHS = ("olmo-1b", "mixtral-8x7b", "jamba-1.5-large-398b")
LR = AdamWConfig().lr
CLI = ["--arch", "olmo-1b", "--smoke", "--steps", "12", "--batch", "4",
       "--seq", "64", "--device", "cpu", "--save-every", "4"]


def run_worker(case: str, out: Path, *args) -> dict:
    subprocess.run([sys.executable, str(WORKER), case, str(out), *args],
                   check=True, timeout=600, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return torch.load(out / f"{case}.pt", weights_only=False)


# --------------------------------------------------------------------------- #
# constrain on a (2, 2) mesh
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def constrained(tmp_path_factory):
    return run_worker("constrain", tmp_path_factory.mktemp("constrain"))


def test_constrain_is_identity_outside_ctx_on_four_ranks(constrained):
    assert constrained["identity_outside"]
    assert constrained["rules_outside"] is None


def test_constrain_applies_the_rule_and_keeps_the_values(constrained):
    from torch.distributed.tensor import Shard
    assert constrained["rules_inside"]
    assert constrained["seen"][0] == ("heads", ("data", None, "model", None))
    assert constrained["heads_placements"] == (Shard(0), Shard(2))
    assert constrained["heads_local"] == (1, 8, 2, 2)
    assert constrained["heads_equal"]


def test_constrain_redistributes_a_dtensor_and_traces_through_arithmetic(
        constrained):
    from torch.distributed.tensor import Replicate, Shard
    assert constrained["residual_placements"] == (Shard(0), Replicate())
    assert constrained["residual_equal"]
    assert constrained["scaled_equal"]


def test_unknown_rule_and_none_are_noops_and_ctx_restores(constrained):
    assert constrained["unknown_is_x"] and constrained["none_is_x"]
    assert constrained["rules_after"] is None


# --------------------------------------------------------------------------- #
# the placed train step on four gloo ranks
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def placed_runs(arch: str, out: str) -> dict:
    return run_worker("train", Path(out), arch)


@functools.lru_cache(maxsize=None)
def one_process(arch: str):
    return worker.run_trainer(arch, make_host_mesh(device_type="cpu"))


@pytest.fixture(scope="module")
def train_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("train")


@pytest.mark.parametrize("mesh", worker.MESHES)
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_placed_train_steps_match_the_one_process_trainer(arch, mesh,
                                                          train_dir):
    losses, norms, params = placed_runs(arch, str(train_dir / arch))[mesh]
    want_losses, want_norms, want_params = one_process(arch)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
    assert set(params) == set(want_params)
    for name, want in want_params.items():
        bound = 1e-6 * float(want.abs().max()) + 1e-5 * LR
        diff = float((params[name] - want).abs().max())
        assert diff <= bound, (name, diff, bound)


def test_without_a_process_group_the_trainer_holds_plain_tensors():
    from torch.distributed.tensor import DTensor
    model, init_state, step, _ = build_trainer(
        get_smoke_config("olmo-1b"), AdamWConfig(), make_host_mesh(
            device_type="cpu"), device="cpu")
    _, opt = init_state(torch.Generator().manual_seed(0))
    tensors = [*model.parameters(), opt.step, *opt.mu.values()]
    assert not any(isinstance(t, DTensor) for t in tensors)


# --------------------------------------------------------------------------- #
# the CLI under torch.distributed.run; its checkpoint across meshes
# --------------------------------------------------------------------------- #


def torchrun(args: list, cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=600, cwd=cwd,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))


def step_losses(stdout: str) -> dict:
    return {int(line.split()[1]): float(line.split()[3])
            for line in stdout.splitlines() if line.startswith("step ")}


#: the four-rank CLI's losses against the one-process run's.  The CLI
#: trains the smoke config in bf16 (its step 0 loss sums bf16 products in
#: another order on four ranks: 1.7e-5 apart), and over 12 steps at its
#: AdamW eps (1e-8) Adam's update g / (|g| + eps) turns gradient rounding
#: into parameter differences that grow step by step: the one-process CLI
#: itself ends 4.2e-5 apart with --grad-accum 2 (the same sums, split),
#: the four-rank run 7.5e-5.  The f32 train cases above hold placement to
#: 1e-5.
CLI_RTOL = 2e-4


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    ckpt = tmp / "ckpt"
    args = CLI + ["--ckpt-dir", str(ckpt), "--model-axis", "2"]
    fault = torchrun(args + ["--inject-fault-at", "6"], tmp)
    resumed = torchrun(args + ["--resume"], tmp)
    whole = torchrun(CLI + ["--ckpt-dir", str(tmp / "whole"),
                            "--model-axis", "2"], tmp)
    return {"fault": fault, "resumed": resumed, "whole4": whole,
            "ckpt": ckpt, "tmp": tmp,
            "whole": train_main(CLI + ["--ckpt-dir", str(tmp / "one")])}


def test_cli_on_four_ranks_resumes_after_a_fault(cli):
    fault, resumed, whole4 = cli["fault"], cli["resumed"], cli["whole4"]
    assert fault.returncode != 0
    assert "injected fault at step 6" in fault.stderr
    for run in (resumed, whole4):
        assert run.returncode == 0, run.stderr[-2000:]
    lines = resumed.stdout.splitlines()
    assert lines[0] == "resumed from step 4"
    assert lines.count("resumed from step 4") == 1      # rank 0 alone prints
    record = json.loads(lines[-1])
    uninterrupted = json.loads(whole4.stdout.splitlines()[-1])
    assert record["steps_run"] == 8 and record["resumed"] == 1
    assert uninterrupted["steps_run"] == 12
    # the restart lands on the uninterrupted four-rank run, to the bit
    assert record["final_loss"] == uninterrupted["final_loss"]
    assert step_losses(resumed.stdout) == {
        s: v for s, v in step_losses(whole4.stdout).items() if s >= 4}
    whole = cli["whole"]
    np.testing.assert_allclose(uninterrupted["first_loss"], whole[0],
                               rtol=CLI_RTOL)
    np.testing.assert_allclose(record["final_loss"], whole[-1],
                               rtol=CLI_RTOL)


def restored_in_one_process(ckpt: Path, step: int):
    model, init_state, _, shardings = build_trainer(
        get_smoke_config("olmo-1b"), AdamWConfig(), make_host_mesh(
            device_type="cpu"), device="cpu")
    carry = init_state(torch.Generator().manual_seed(1))
    (model, opt), got = Checkpointer(str(ckpt)).restore(step, carry,
                                                        shardings)
    return model, opt, got


def test_checkpoint_of_two_by_two_restores_on_four_by_one_to_the_bit(cli):
    from torch.distributed.tensor import Replicate, Shard
    model, opt, step = restored_in_one_process(cli["ckpt"], 12)
    res = run_worker("restore", cli["tmp"] / "restore", str(cli["ckpt"]),
                     "12", "1")
    assert res["step"] == step == 12 and res["opt_step"] == int(opt.step)
    assert res["placements"]["layers.0.attn.wq"] == (Shard(0), Replicate())
    for name, p in model.named_parameters():
        assert torch.equal(res["params"][name], p.detach()), name
    for key in ("mu", "nu"):
        for name, t in getattr(opt, key).items():
            assert torch.equal(res[key][name], t), (key, name)


def test_checkpoint_of_four_ranks_is_read_by_the_jax_package(cli):
    model, opt, _ = restored_in_one_process(cli["ckpt"], 12)
    jcfg = jax_smoke_config("olmo-1b")
    _, jparams = jax_eval_shape_params(jcfg)
    jopt = jax.eval_shape(jax_init_opt_state, jparams)
    (rparams, ropt), at = JaxCheckpointer(str(cli["ckpt"])).restore(
        12, (jparams, jopt))
    assert at == 12 and int(ropt.step) == 12 == int(opt.step)
    for want, got in ((model, rparams), (opt.mu, ropt.mu),
                      (opt.nu, ropt.nu)):
        want = restacked(want)
        flat = dict(flat_specs(got))
        assert set(flat) == set(want)
        for k, g in flat.items():
            assert np.array_equal(np.asarray(g), want[k]), k


# --------------------------------------------------------------------------- #
# several axes in one entry: mesh order
# --------------------------------------------------------------------------- #


def _entries(spec):
    return [e for e in spec if isinstance(e, tuple)]


@pytest.mark.parametrize("arch", ARCHS)
def test_every_multi_axis_entry_names_its_axes_in_mesh_order(arch):
    mesh = make_production_mesh(multi_pod=True)
    order = {a: i for i, a in enumerate(mesh.axis_names)}
    cfg = get_config(arch)
    specs = []
    model, params = eval_shape_params(cfg)
    specs += [sh.spec for _, sh in flat_specs(param_shardings(
        model, mesh, cfg))]
    rules = make_activation_rules(mesh, cfg)
    for sname, shape in SHAPES.items():
        for t in input_specs(cfg, shape).values():
            specs.append(batch_spec("x", tuple(t.shape), mesh))
        B, T = shape.global_batch, shape.seq_len
        for name, dims in (("residual", (B, T, cfg.d_model)),
                           ("heads", (B, T, cfg.n_heads, cfg.hd)),
                           ("scores", (B, cfg.n_heads, T, T)),
                           ("logits", (B, T, cfg.vocab_size))):
            specs.append(rules(name, dims).spec)
        if shape.kind == "decode":
            cache = eval_shape_cache(cfg, B, T)
            specs += [sh.spec for _, sh in flat_specs(cache_shardings(
                cache, mesh, cfg))]
    multi = [e for s in specs for e in _entries(s)]
    assert multi, "no rule cuts one dimension over several axes"
    for entry in multi:
        assert [order[a] for a in entry] == sorted(order[a] for a in entry)
