"""``repro_torch.kernels.ops.scheduled_gemm``: the compiler's plan, the bridge
and K1.  A request is one GEMM of the configuration's list (``"request":
"call"``) or one pass over all of them (``"pass"``); C is checked against
``reference.gemm`` from the same A and B."""
from __future__ import annotations

import torch

from portbench import counts, reference


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        from repro_torch.kernels import ops
        self.ops = ops
        self.shapes = [tuple(s) for s in config["shapes"]]
        self.dtype = getattr(torch, traffic["dtype"])
        self.whole_pass = traffic["request"] == "pass"
        self.classes = (["pass"] if self.whole_pass
                        else ["x".join(map(str, s)) for s in self.shapes])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        pool = traffic["pool"]
        # one draw a shape for all slots: A (pool, m, k) and B (pool, k, n)
        self.a, self.b = [], []
        for m, n, k in self.shapes:
            self.a.append(torch.randn((pool, m, k), generator=gen,
                                      device=device, dtype=self.dtype))
            self.b.append(torch.randn((pool, k, n), generator=gen,
                                      device=device, dtype=self.dtype))

    def _gemms(self, req):
        cls, _ = req
        return range(len(self.shapes)) if self.whole_pass else (cls,)

    def call(self, req):
        slot = req[1]
        return [self.ops.scheduled_gemm(self.a[i][slot], self.b[i][slot])[0]
                for i in self._gemms(req)]

    def control(self, req):
        slot = req[1]
        prec = "tf32" if self.dtype == torch.float32 else "fp8"
        return [reference.gemm(self.a[i][slot], self.b[i][slot], self.dtype,
                               prec) for i in self._gemms(req)]

    def flops(self, req) -> float:
        return sum(counts.gemm_flops(*self.shapes[i]) for i in self._gemms(req))

    def work(self, req) -> dict:
        return {"k1": [self.shapes[i] for i in self._gemms(req)]}

    def plan(self, req) -> None:
        for i in self._gemms(req):
            m, n, k = self.shapes[i]
            self.ops.plan_gemm(m, n, k, dtype=self.dtype)

    def compile_set(self) -> None:
        from repro_torch.compile import compile_gemm
        for m, n, k in self.shapes:
            compile_gemm(m, n, k, approach="greedy")

    def reset(self) -> None:
        pass

    def free(self) -> None:
        pass

    def check(self, samples) -> dict:
        worst = 0.0
        for req, outs in samples:
            slot = req[1]
            for i, c in zip(self._gemms(req), outs):
                want = reference.gemm(self.a[i][slot], self.b[i][slot],
                                      self.dtype)
                worst = max(worst, reference.rel_rms(c, want))
        return {"rel_rms": worst}
