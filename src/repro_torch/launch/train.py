"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \
        --steps 50 --batch 8 --seq 128 --device cpu

Runs the full stack: config -> model -> train step (AdamW in place, the
activation rules of the host mesh active) -> deterministic data pipeline ->
checkpoint/restart runtime with straggler detection.  ``--smoke`` uses the
reduced config so the driver runs on the CPU; without ``--device`` it runs
on the card (and raises when there is none), where the published configs
train too (olmo-1b's AdamW state is 20.5 GB).
"""
from __future__ import annotations

import argparse
import json

import torch

from ..checkpoint.ckpt import Checkpointer
from ..configs import ARCHS, get_config, get_smoke_config
from ..data.pipeline import (DataConfig, add_frontend_stub, host_local_batch,
                             make_source)
from ..dist.ctx import activation_sharding_ctx
from ..dist.sharding import (batch_shardings, make_activation_rules,
                             param_shardings, replicated)
from ..kernels.cuda import resolve_device
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, OptState
from ..runtime.fault_tolerance import TrainingRuntime
from .caches import activate_caches
from .mesh import make_host_mesh
from .steps import make_train_step


def build_trainer(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                  grad_accum: int = 1, device=None):
    """(model, init_state, step, (param shardings, opt shardings)) on
    ``device`` (the card when None).  ``init_state(generator)`` draws the
    parameters from ``generator`` (a ``torch.Generator`` on the device),
    zeroes the optimizer state and returns the carry ``(model, opt_state)``;
    ``step(carry, batch)`` takes a host batch through one train step with
    the mesh's activation rules active and returns ``(carry, metrics)``.
    The carry's tensors are updated in place."""
    dev = resolve_device(device)
    model, opt_state, train_step = make_train_step(cfg, opt_cfg, grad_accum,
                                                   dev)
    rules = make_activation_rules(mesh, cfg)
    p_sh = param_shardings(model, mesh, cfg)
    o_sh = OptState(step=replicated(mesh), mu=p_sh, nu=p_sh)

    def init_state(generator: torch.Generator):
        model.init(generator)
        with torch.no_grad():
            opt_state.step.zero_()
            for t in (*opt_state.mu.values(), *opt_state.nu.values()):
                t.zero_()
        return model, opt_state

    def step(carry, batch):
        batch = host_local_batch(batch, mesh, batch_shardings(batch, mesh))
        with activation_sharding_ctx(rules):
            metrics = train_step(batch)
        return carry, metrics

    return model, init_state, step, (p_sh, o_sh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises when "
                         "there is none)")
    ap.add_argument("--tuned", action="store_true",
                    help="activate the repro_torch.search tuning cache and "
                         "the repro_torch.compile artifact cache for this "
                         "process: cache-aware kernels pick up autotuned "
                         "configs; the models' products are torch.matmul "
                         "and torch.einsum and are unaffected")
    ap.add_argument("--tuning-cache", default=None, metavar="PATH",
                    help="tuning cache path (with --tuned)")
    ap.add_argument("--compile-cache", default=None, metavar="PATH",
                    help="artifact cache path (with --tuned)")
    ap.add_argument("--tuning-model", default=None, metavar="PATH",
                    help="learned cost model store (with --tuned): untuned "
                         "GEMM shapes get a model-predicted block")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.tuned:
        activate_caches(args.tuning_cache, args.compile_cache,
                        model_path=args.tuning_model)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    mesh = make_host_mesh(model=args.model_axis, device_type=dev.type)

    model, init_state, step, (p_sh, o_sh) = build_trainer(
        cfg, opt_cfg, mesh, args.grad_accum, dev)

    dcfg = DataConfig(seed=17, global_batch=args.batch, seq_len=args.seq)
    source = make_source(dcfg, cfg)

    def batch_fn(s):
        b = source.batch(s)
        return add_frontend_stub(b, cfg, s, seed=dcfg.seed)

    ckpt = Checkpointer(args.ckpt_dir)
    rt = TrainingRuntime(ckpt, save_every=args.save_every)
    rt.install_preemption_handler()

    def fresh():
        return init_state(torch.Generator(dev).manual_seed(0))

    carry = None
    if args.resume:
        restored = rt.try_restore(fresh(), shardings=(p_sh, o_sh))
        if restored is not None:
            carry = restored[0]
            print(f"resumed from step {restored[1]}")
    if carry is None:
        carry = fresh()

    losses = []

    def on_metrics(s, m, dt, slow):
        loss = float(m["loss"])
        losses.append(loss)
        flag = " SLOW" if slow else ""
        if s % 10 == 0 or s == args.steps - 1:
            print(f"step {s:5d} loss {loss:.4f} gnorm "
                  f"{float(m['grad_norm']):.3f} {dt*1e3:.0f}ms{flag}",
                  flush=True)

    try:
        carry = rt.run(carry, step, batch_fn, args.steps, on_metrics,
                       inject_fault_at=args.inject_fault_at)
    finally:        # a save in flight when the loop raises is committed
        ckpt.wait()
    print(json.dumps({"final_loss": losses[-1] if losses else None,
                      "first_loss": losses[0] if losses else None,
                      "steps_run": len(losses),
                      "slow_steps": len(rt.straggler.slow_steps),
                      "resumed": rt.state.resumed}))
    return losses


if __name__ == "__main__":
    main()
