"""``repro_torch.graph``: whisper's decoder stack traced
(``trace_whisper_decoder``), its epilogues fused (``fuse_epilogues``),
compiled (``compile_graph``) and run by ``CompiledGraph.execute``: GEMM
nodes through K1 and K2, the rest through the program's interpreter.  Each
prompt length of the traffic is a class with a graph of its own; a request
is one class's graph on one pool slot's prompt and frames.

The four graphs are compiled in ``compile_set``, which set-up calls before
the first request, and ``call`` runs what it compiled.  What is checked:
the logits and the last layer's stream of each kept request against
``whisper_reference.decoder`` from the same inputs, in float64.  Operations
and the rooflines' work come from the layer's equations at whole width
(``gemms``), not from the traced graph.  The program's tracer is imported
with this module, so a program without it fails as the cell is loaded."""
from __future__ import annotations

import torch
from repro_torch.graph import (compile_graph, fuse_epilogues,
                               trace_whisper_decoder, whisper_inputs)
from repro_torch.models.config import ModelConfig

from portbench import reference, whisper_reference


def gemms(T: int, S: int, D: int, heads: int, F: int, V: int,
          layers: int) -> list[tuple[int, int, int, int]]:
    """The GEMMs of ``layers`` decoder layers and the head at whole width,
    as (m, n, k, batch) for ``batch`` products of (m, k) by (k, n): per
    layer the self-attention's q, k, v, scores, weighted values and output
    projection, the cross-attention's (keys and values over the ``S``
    frames), the MLP's two; then the logits."""
    dh = D // heads
    per_layer = [(T, D, D, 1), (T, D, D, 1), (T, D, D, 1),
                 (T, T, dh, heads), (T, dh, T, heads), (T, D, D, 1),
                 (T, D, D, 1), (S, D, D, 1), (S, D, D, 1),
                 (T, S, dh, heads), (T, dh, S, heads), (T, D, D, 1),
                 (T, F, D, 1), (T, D, F, 1)]
    return per_layer * layers + [(T, V, D, 1)]


def gemm_flops(shape) -> float:
    m, n, k, batch = shape
    return 2.0 * batch * m * n * k


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        c = config
        self.device = device
        self.layers = c["decoder_layers"]
        self.heads = c["decoder_attention_heads"]
        D, F, V = c["d_model"], c["decoder_ffn_dim"], c["vocab_size"]
        S = c["max_source_positions"]
        self.seq_lens = list(traffic["seq_lens"])
        self.classes = [f"T{t}" for t in self.seq_lens]
        self.work_shapes = [gemms(t, S, D, self.heads, F, V, self.layers)
                            for t in self.seq_lens]
        cfg = ModelConfig(name=c["name"], family="audio", n_layers=self.layers,
                          d_model=D, n_heads=self.heads, n_kv_heads=self.heads,
                          d_ff=F, vocab_size=V, head_dim=c["head_dim"],
                          dtype=traffic["dtype"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.params = whisper_reference.init_params(D, F, V, self.layers, gen,
                                                    device)
        pool = traffic["pool"]
        self.x = [[torch.randn((t, D), generator=gen, device=device)
                   for _ in range(pool)] for t in self.seq_lens]
        self.xa = [[torch.randn((S, D), generator=gen, device=device)
                    for _ in range(pool)] for _ in self.seq_lens]
        self.graphs = [fuse_epilogues(trace_whisper_decoder(cfg, t, S,
                                                            self.layers))
                       for t in self.seq_lens]
        # the per-head weights are sliced once and shared by every input set
        weights = self.params
        self.inputs = []
        for cls, (g, _) in enumerate(self.graphs):
            self.inputs.append([])
            for slot in range(pool):
                ins = whisper_inputs(g, weights, self.x[cls][slot],
                                     self.xa[cls][slot])
                weights = ins
                self.inputs[cls].append(ins)
        self.outputs = [g.outputs for g, _ in self.graphs]
        self.compiled = None
        self.refs: dict = {}

    def call(self, req):
        cls, slot = req
        return self.compiled[cls].execute(self.inputs[cls][slot],
                                          device=self.device)

    def _reference(self, req, precision: str = "config"):
        cls, slot = req
        return whisper_reference.decoder(self.params, self.x[cls][slot],
                                         self.xa[cls][slot], self.heads,
                                         self.layers, precision)

    def control(self, req):
        h, logits = self._reference(req, "tf32")
        stream, out = self.outputs[req[0]]
        return {stream: h.float(), out: logits.float()}

    def flops(self, req) -> float:
        return sum(gemm_flops(s) for s in self.work_shapes[req[0]])

    def work(self, req) -> dict:
        return {"gemm": self.work_shapes[req[0]]}

    def plan(self, req) -> None:
        pass

    def compile_set(self) -> None:
        self.compiled = [compile_graph(g, decisions=d)
                         for g, d in self.graphs]

    def reset(self) -> None:
        pass

    def free(self) -> None:
        self.compiled = self.graphs = self.inputs = None

    def check(self, samples) -> dict:
        worst = {"rel_rms": 0.0, "stream_rel_rms": 0.0}
        for req, out in samples:
            key = tuple(req)
            if key not in self.refs:
                self.refs[key] = self._reference(key)
            h, logits = self.refs[key]
            stream, head = self.outputs[req[0]]
            worst["rel_rms"] = max(worst["rel_rms"],
                                   reference.rel_rms(out[head], logits))
            worst["stream_rel_rms"] = max(worst["stream_rel_rms"],
                                          reference.rel_rms(out[stream], h))
        return worst
