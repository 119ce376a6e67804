"""``repro_torch.kernels.ops.scheduled_gru``: the compiler's plans, K2's input
projection and K4's persistent recurrence.  A request is one sequence of
``steps`` steps at one (batch, hidden) size of the configuration, input =
hidden; its final h is checked against ``reference.gru_seq`` from the raw
weights, the same xs and the same h0."""
from __future__ import annotations

import torch

from portbench import counts, reference
from portbench.entries.gru_weights import make_weights, uniform


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        from repro_torch.kernels import ops
        from repro_torch.kernels.gru import FusedGRU
        self.ops = ops
        self.sizes = [tuple(s) for s in config["sizes"]]
        self.steps = config["steps"]
        self.dtype = getattr(torch, traffic["dtype"])
        self.classes = [f"{b}x{h}" for b, h in self.sizes]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        pool = traffic["pool"]
        self.weights, self.models, self.xs, self.h0 = [], [], [], []
        for batch, hidden in self.sizes:
            w = make_weights(hidden, hidden, self.dtype, gen, device)
            model = FusedGRU(hidden, hidden, device=device, dtype=self.dtype)
            for name, t in w.items():
                getattr(model, name).copy_(t)
            self.weights.append(w)
            self.models.append(model)
            self.xs.append(uniform((pool, self.steps, batch, hidden),
                                   self.dtype, gen, device))
            self.h0.append(uniform((pool, batch, hidden), self.dtype, gen,
                                   device))

    def call(self, req):
        cls, slot = req
        return self.ops.scheduled_gru(self.xs[cls][slot], self.h0[cls][slot],
                                      self.models[cls])

    def control(self, req):
        cls, slot = req
        wts = reference.GRUWeights(self.weights[cls], "fp8")
        return reference.gru_seq(self.xs[cls][slot], self.h0[cls][slot], wts,
                                 self.dtype)

    def flops(self, req) -> float:
        batch, hidden = self.sizes[req[0]]
        return counts.gru_seq_flops(self.steps, batch, hidden, hidden)

    def work(self, req) -> dict:
        batch, hidden = self.sizes[req[0]]
        return {"k2": [(self.steps * batch, 3 * hidden, hidden)],
                "k4": [(self.steps, batch, hidden)]}

    def plan(self, req) -> None:
        batch, hidden = self.sizes[req[0]]
        self.ops.plan_gemm(self.steps * batch, 3 * hidden, hidden,
                           dtype=self.dtype)
        self.ops.plan_gru(batch, hidden, hidden)

    def compile_set(self) -> None:
        from repro_torch.compile import compile_gemm, compile_gru
        for batch, hidden in self.sizes:
            compile_gemm(self.steps * batch, 3 * hidden, hidden,
                         approach="greedy")
            compile_gru(batch, hidden, hidden, approach="greedy")

    def reset(self) -> None:
        pass

    def free(self) -> None:
        self.models = None

    def check(self, samples) -> dict:
        worst = 0.0
        for (cls, slot), h in samples:
            wts = reference.GRUWeights(self.weights[cls])
            want = reference.gru_seq(self.xs[cls][slot], self.h0[cls][slot],
                                     wts, self.dtype)
            worst = max(worst, reference.rel_rms(h, want))
        return {"rel_rms": worst}
