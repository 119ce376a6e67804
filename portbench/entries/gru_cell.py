"""``repro_torch.kernels.gru.gru_cell``: K3, one GRU step, at the tile that
``gru_tile(plan_gru(...))`` gives in set-up.  Each (batch, hidden) size of
the configuration is a stream whose hidden state is carried from request to
request, as in streaming inference; a request is one step of one stream.

What is checked: each kept step against ``reference.gru_step`` from the
same x and the h the step was given, and the first ``start_steps`` steps of
every stream against the reference's own chain from the initial h.  The
reference does not replay every stream to its end: it would take longer
than the window."""
from __future__ import annotations

import torch

from portbench import counts, reference
from portbench.entries.gru_weights import make_weights, uniform


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        from repro_torch.kernels import gru, ops
        self.ops, self.gru = ops, gru
        self.sizes = [tuple(s) for s in config["sizes"]]
        self.dtype = getattr(torch, traffic["dtype"])
        self.start_steps = traffic["start_steps"]
        self.classes = [f"{b}x{h}" for b, h in self.sizes]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        pool = traffic["pool"]
        self.weights, self.x, self.h_init = [], [], []
        for batch, hidden in self.sizes:
            self.weights.append(make_weights(hidden, hidden, self.dtype, gen,
                                             device))
            self.x.append(uniform((pool, batch, hidden), self.dtype, gen,
                                  device))
            self.h_init.append(uniform((batch, hidden), self.dtype, gen,
                                       device))
        self.tiles = [ops.gru_tile(ops.plan_gru(b, h, h)[0])
                      for b, h in self.sizes]
        self.control_wts = None
        self.reset()

    def reset(self) -> None:
        """Every stream back at its initial h; the first steps recorded
        anew (x slots and outputs)."""
        self.h = list(self.h_init)
        self.start = [([], []) for _ in self.sizes]

    def _step(self, req, out):
        cls, slot = req
        h_in = self.h[cls]
        self.h[cls] = out
        slots, outs = self.start[cls]
        if len(slots) < self.start_steps:
            slots.append(slot)
            outs.append(out)
        return slot, h_in, out

    def call(self, req):
        cls, slot = req
        out = self.gru.gru_cell(self.x[cls][slot], self.h[cls],
                                self.weights[cls], tile=self.tiles[cls])
        return self._step(req, out)

    def control(self, req):
        cls, slot = req
        if self.control_wts is None:
            self.control_wts = [reference.GRUWeights(w, "fp8")
                                for w in self.weights]
        out = reference.gru_step(self.x[cls][slot], self.h[cls],
                                 self.control_wts[cls], self.dtype)
        return self._step(req, out)

    def flops(self, req) -> float:
        batch, hidden = self.sizes[req[0]]
        return counts.gru_step_flops(batch, hidden, hidden)

    def work(self, req) -> dict:
        batch, hidden = self.sizes[req[0]]
        return {"k3": [(batch, hidden, hidden)]}

    def plan(self, req) -> None:
        pass

    def compile_set(self) -> None:
        from repro_torch.compile import compile_gru
        for batch, hidden in self.sizes:
            compile_gru(batch, hidden, hidden, approach="greedy")

    def free(self) -> None:
        self.h = None

    def check(self, samples) -> dict:
        wts = [reference.GRUWeights(w) for w in self.weights]
        worst_step = 0.0
        for (cls, _), (slot, h_in, out) in samples:
            want = reference.gru_step(self.x[cls][slot], h_in, wts[cls],
                                      self.dtype)
            worst_step = max(worst_step, reference.rel_rms(out, want))
        worst_start = 0.0
        for cls, (slots, outs) in enumerate(self.start):
            h = self.h_init[cls]
            for slot, out in zip(slots, outs):
                h = reference.gru_step(self.x[cls][slot], h, wts[cls],
                                       self.dtype)
                worst_start = max(worst_start, reference.rel_rms(out, h))
        return {"rel_rms": worst_step, "start_rel_rms": worst_start}
