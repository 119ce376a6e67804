"""Fault-tolerance runtime: restartable training loop, straggler detection,
elastic re-meshing.

Designed for 1000+ node operation:

  * **Checkpoint/restart** — the loop is a pure function of (checkpoint,
    step): any crash resumes from the last committed step; the data pipeline
    is step-keyed so there is no replay drift.
  * **Straggler mitigation** — per-step wall times feed an EWMA; steps slower
    than ``threshold x EWMA`` fire a callback (in production: re-shard away
    from the slow host / alert; here: recorded + surfaced in metrics).
  * **Elastic re-meshing** — on restart the checkpoint is re-sharded onto
    whatever mesh is available (restore takes the *new* shardings).
  * **Preemption hooks** — SIGTERM triggers a final synchronous checkpoint.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

from ..checkpoint.ckpt import Checkpointer


@dataclass
class StragglerDetector:
    alpha: float = 0.2
    threshold: float = 2.0
    ewma: float = 0.0
    slow_steps: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma == 0.0:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.slow_steps.append((step, dt, self.ewma))
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


@dataclass
class RunState:
    step: int = 0
    crashed: int = 0
    resumed: int = 0
    preempted: bool = False


class TrainingRuntime:
    """Wraps a compiled step function with checkpoint/restart + monitoring."""

    def __init__(self, ckpt: Checkpointer, save_every: int = 50,
                 async_save: bool = True,
                 straggler: StragglerDetector | None = None):
        self.ckpt = ckpt
        self.save_every = save_every
        self.async_save = async_save
        self.straggler = straggler or StragglerDetector()
        self.state = RunState()
        self._stop = False

    def install_preemption_handler(self):
        def handler(signum, frame):
            self.state.preempted = True
            self._stop = True
        signal.signal(signal.SIGTERM, handler)

    # -- resume -----------------------------------------------------------------
    def try_restore(self, template, shardings=None):
        """Latest committed checkpoint -> (state_tree, step) or None."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return None
        tree, step = self.ckpt.restore(latest, template, shardings)
        self.state.step = step
        self.state.resumed += 1
        return tree, step

    # -- loop ----------------------------------------------------------------------
    def run(self, carry, step_fn, batch_fn, n_steps: int,
            on_metrics=None, inject_fault_at: int | None = None):
        """carry: (params, opt_state).  step_fn(carry, batch) -> (carry,
        metrics).  batch_fn(step) -> batch.  ``inject_fault_at`` simulates a
        crash (tests restart semantics)."""
        start = self.state.step
        for step in range(start, n_steps):
            if self._stop:
                break
            t0 = time.perf_counter()
            batch = batch_fn(step)
            carry, metrics = step_fn(carry, batch)
            dt = time.perf_counter() - t0
            slow = self.straggler.observe(step, dt)
            self.state.step = step + 1
            if on_metrics is not None:
                on_metrics(step, metrics, dt, slow)
            if inject_fault_at is not None and step + 1 == inject_fault_at:
                self.state.crashed += 1
                raise RuntimeError(f"injected fault at step {step + 1}")
            if (step + 1) % self.save_every == 0:
                self.ckpt.save(step + 1, carry, blocking=not self.async_save)
        self.ckpt.save(self.state.step, carry, blocking=True)
        return carry
