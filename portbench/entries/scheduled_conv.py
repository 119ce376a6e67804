"""``repro_torch.kernels.ops.scheduled_conv``: the compiler's conv extraction
(``compile_conv``), the bridge and K1.  A request is one forward's layers of
the configuration, in network order (``"request": "pass"``, one class): each
a stride-1 1x1 convolution of an NHWC input of its own by the model's
filter, waited for once at the end.  Each output is checked against
``resnet_reference.conv1x1`` from the same x and w, rounded once to the
configuration's dtype.  The bridge is imported with this module, so a
program without it fails as the cell is loaded."""
from __future__ import annotations

import torch
from repro_torch.compile import compile_conv
from repro_torch.kernels.ops import plan_conv, scheduled_conv

from portbench import counts, reference, resnet_reference


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.batch = config["batch"]
        self.layers = [(c["h"], c["w"], c["cin"], c["cout"])
                       for c in config["layers"]]
        self.dtype = getattr(torch, traffic["dtype"])
        self.classes = ["pass"]
        #: each layer's GEMM (m, n, k) = (batch h w, cout, cin)
        self.shapes = [(self.batch * h * w, cout, cin)
                       for h, w, cin, cout in self.layers]
        self.pass_flops = sum(counts.gemm_flops(*s) for s in self.shapes)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.w = [resnet_reference.init_weight(cin, cout, gen,
                                               device).to(self.dtype)
                  for _, _, cin, cout in self.layers]
        # each slot holds an input a layer: no layer reads another's output
        self.x = [[torch.randn((self.batch, h, w, cin), generator=gen,
                               device=device, dtype=self.dtype)
                   for h, w, cin, _ in self.layers]
                  for _ in range(traffic["pool"])]

    def call(self, req):
        xs = self.x[req[1]]
        return [scheduled_conv(x, w)[0] for x, w in zip(xs, self.w)]

    def control(self, req):
        xs = self.x[req[1]]
        return [resnet_reference.conv1x1(x, w, "fp8").to(self.dtype)
                for x, w in zip(xs, self.w)]

    def flops(self, req) -> float:
        return self.pass_flops

    def work(self, req) -> dict:
        return {"k1": self.shapes}

    def plan(self, req) -> None:
        for h, w, cin, cout in self.layers:
            plan_conv(self.batch, h, w, cin, cout, self.dtype)

    def compile_set(self) -> None:
        for h, w, cin, cout in dict.fromkeys(self.layers):
            compile_conv(approach="greedy", batch=self.batch, h=h, w=w,
                         kh=1, kw=1, cin=cin, cout=cout)

    def reset(self) -> None:
        pass

    def free(self) -> None:
        pass

    def check(self, samples) -> dict:
        """The worst relative RMS error of any kept output; the reference
        of a slot's layer is computed once for all its kept passes."""
        kept: dict[int, list] = {}
        for req, outs in samples:
            kept.setdefault(req[1], []).append(outs)
        worst = 0.0
        for slot, passes in kept.items():
            for i, (x, w) in enumerate(zip(self.x[slot], self.w)):
                want = resnet_reference.conv1x1(x, w).to(self.dtype)
                for outs in passes:
                    worst = max(worst, reference.rel_rms(outs[i], want))
        return {"rel_rms": worst}
