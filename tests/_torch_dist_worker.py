"""Multi-rank cases of ``tests/test_torch_dist.py``, run in a process of
their own: ``python tests/_torch_dist_worker.py <case> <out dir> [args]``
starts ``WORLD`` CPU processes joined by a ``gloo`` process group (a
``FileStore`` in the out dir) and runs ``case`` on every rank; rank 0
writes what the test reads into the out dir with ``torch.save``.

Cases:
  train <arch>        the placed trainer, f32 smoke config, 2 steps, on the
                      (2, 2), (4, 1) and (1, 4) meshes in turn: losses,
                      grad norms and every parameter gathered whole
  constrain           ``dist.ctx.constrain`` on a (2, 2) mesh
  restore <ckpt dir> <step> <model axis>
                      the smoke trainer's state restored from a checkpoint
                      onto a (4 / axis, axis) mesh, gathered whole

``placement`` runs in this one process, on a ``fake`` group of 512 ranks:
every parameter, moment, batch and cache leaf of every arch's full config
placed on both production meshes under ``FakeTensorMode``, its local
shape against the shape its spec implies (``shard_shape``).
"""
from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

WORLD = 4
MESHES = ((2, 2), (4, 1), (1, 4))
BATCH, SEQ, STEPS = 4, 32, 2
#: AdamW eps of the train case.  Each mesh sums a gradient in its own
#: order, and Adam's update g / (|g| + eps) turns that rounding into a
#: parameter difference of lr |dg| / eps where |g| << eps: at 1e-8 up to
#: 2 lr; at 1e-3 jamba's conv_b (values ~6e-4) came 4.6e-9 apart, 1.28
#: times the 1e-6 max|leaf| + 1e-5 lr bound
EPS = 1e-2


def f32_smoke(arch: str):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).scaled(dtype="float32")


def run_trainer(arch: str, mesh, steps: int = STEPS):
    """(losses, grad norms, {name: whole parameter}) of the trainer on
    ``mesh`` from seed 0, ``steps`` steps of the seeded synthetic data."""
    from repro_torch.data.pipeline import (DataConfig, add_frontend_stub,
                                           make_source)
    from repro_torch.dist.sharding import full
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.adamw import AdamWConfig

    cfg = f32_smoke(arch)
    model, init_state, step, _ = build_trainer(
        cfg, AdamWConfig(warmup_steps=1, eps=EPS), mesh, device="cpu")
    carry = init_state(torch.Generator("cpu").manual_seed(0))
    source = make_source(DataConfig(seed=17, global_batch=BATCH,
                                    seq_len=SEQ), cfg)
    losses, norms = [], []
    for s in range(steps):
        batch = add_frontend_stub(source.batch(s), cfg, s, seed=17)
        carry, m = step(carry, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    params = {n: full(p.detach()).clone()
              for n, p in model.named_parameters()}
    return losses, norms, params


def case_train(out: str, arch: str):
    from repro_torch.launch.mesh import make_host_mesh

    res = {}
    for shape in MESHES:
        mesh = make_host_mesh(model=shape[1], device_type="cpu")
        assert mesh.axis_sizes == shape, mesh
        res[shape] = run_trainer(arch, mesh)
    return res


def case_constrain(out: str):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.dist.ctx import (activation_sharding_ctx, constrain,
                                      current_rules)
    from repro_torch.dist.sharding import full, make_activation_rules
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model=2, device_type="cpu")
    rules = make_activation_rules(mesh, get_config("qwen2-7b"))
    x = torch.arange(2 * 8 * 4 * 2, dtype=torch.float32).reshape(2, 8, 4, 2)
    res = {"identity_outside": constrain(x, "residual") is x,
           "rules_outside": current_rules()}
    seen = []

    def spy(name, shape):
        s = rules(name, shape)
        seen.append((name, None if s is None else tuple(s.spec)))
        return s

    with activation_sharding_ctx(spy):
        res["rules_inside"] = current_rules() is spy
        y = constrain(x, "heads")
        res["heads_placements"] = tuple(y.placements)
        res["heads_local"] = tuple(y.to_local().shape)
        res["heads_equal"] = torch.equal(full(y), x)
        # a DTensor moves from one placement to the rule's
        row = dist.get_rank() // 2           # this rank's row on "data"
        z = constrain(DTensor.from_local(
            x[row:row + 1], mesh.device_mesh, [Shard(0), Replicate()],
            run_check=False), "residual")
        res["residual_placements"] = tuple(z.placements)
        res["residual_equal"] = torch.equal(full(z), x)
        res["unknown_is_x"] = constrain(x, "no_such_rule_name") is x
        w = torch.arange(24.0).reshape(2, 3, 4)
        res["scaled_equal"] = torch.equal(
            full(constrain(w, "residual") * 2.0), w * 2.0)
    res["seen"] = seen
    with activation_sharding_ctx(lambda name, shape: None):
        res["none_is_x"] = constrain(x, "residual") is x
    res["rules_after"] = current_rules()
    return res


def case_restore(out: str, ckpt_dir: str, step: str, axis: str):
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist.sharding import full
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.adamw import AdamWConfig

    mesh = make_host_mesh(model=int(axis), device_type="cpu")
    model, init_state, _, shardings = build_trainer(
        get_smoke_config("olmo-1b"), AdamWConfig(), mesh, device="cpu")
    carry = init_state(torch.Generator("cpu").manual_seed(1))
    (model, opt), got = Checkpointer(ckpt_dir).restore(int(step), carry,
                                                       shardings)
    return {"step": got, "opt_step": int(full(opt.step)),
            "params": {n: full(p.detach()).clone()
                       for n, p in model.named_parameters()},
            "mu": {n: full(t).clone() for n, t in opt.mu.items()},
            "nu": {n: full(t).clone() for n, t in opt.nu.items()},
            "placements": {n: tuple(p.placements)
                           for n, p in model.named_parameters()}}


def placement(out: str):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ARCHS, cell_applicable, get_config
    from repro_torch.configs import input_specs
    from repro_torch.dist.sharding import (batch_shardings, cache_shardings,
                                           layer_shardings, param_shardings,
                                           place_tree, shard_shape)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import (eval_shape_cache,
                                          eval_shape_opt_state,
                                          eval_shape_params)
    from repro_torch.models import SHAPES

    def check(kind, placed, shardings, bad, counts):
        for name, t in placed.items():
            want = shard_shape(t.shape, shardings[name].spec,
                               shardings[name].mesh)
            counts[kind] = counts.get(kind, 0) + 1
            if tuple(t.to_local().shape) != want:
                bad.append([kind, name, list(t.to_local().shape),
                            list(want)])

    res = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, fake_group=True)
        for arch in ARCHS:
            cfg, bad, counts = get_config(arch), [], {}
            with FakeTensorMode():
                model, params = eval_shape_params(cfg, mesh)
                p_sh = layer_shardings(model, param_shardings(model, mesh,
                                                              cfg))
                check("param", params, p_sh, bad, counts)
                opt = eval_shape_opt_state(dict(model.named_parameters()))
                check("mu", opt.mu, p_sh, bad, counts)
                check("nu", opt.nu, p_sh, bad, counts)
                for sname, shape in SHAPES.items():
                    if not cell_applicable(arch, sname):
                        continue
                    specs = input_specs(cfg, shape)
                    b_sh = layer_shardings(specs, batch_shardings(specs,
                                                                  mesh))
                    check("batch", place_tree(specs, b_sh), b_sh, bad,
                          counts)
                    if shape.kind == "decode":
                        cache = eval_shape_cache(cfg, shape.global_batch,
                                                 shape.seq_len)
                        c_sh = layer_shardings(cache, cache_shardings(
                            cache, mesh, cfg))
                        flat = _flat(place_tree(cache, c_sh))
                        check("cache", flat, c_sh, bad, counts)
            res[f"{arch}/{'multi' if multi else 'single'}"] = {
                "bad": bad, "counts": counts}
    return res


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


CASES = {"train": case_train, "constrain": case_constrain,
         "restore": case_restore}


def _rank(rank: int, case: str, out: str, args: list):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out, 'store')}",
        rank=rank, world_size=WORLD)
    try:
        res = CASES[case](out, *args)
        if rank == 0:
            torch.save(res, os.path.join(out, f"{case}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, out, *rest = sys.argv[1:]
    os.makedirs(out, exist_ok=True)
    if case == "placement":
        torch.save(placement(out), os.path.join(out, f"{case}.pt"))
        sys.exit(0)
    store = os.path.join(out, "store")
    if os.path.exists(store):          # a FileStore file is used once
        os.remove(store)
    mp.spawn(_rank, args=(case, out, rest), nprocs=WORLD, join=True)
