"""whisper's decoder stack on the graph tier (``trace_whisper_decoder``) at a
small size on the CPU: the executed graph, fused and unfused, and the
graph interpreter against the plain float64 reference
(``models.whisper_block_reference``); the full-width graph's nodes; how the
executor runs a GEMM node with an epilogue (K1 or K2 once, no (m, n, k)
buffer); and the executor's spans and counters.

Tolerance: the graph rounds every tensor to f32 at each node boundary and
K1 sums in f32, where the reference keeps float64 from end to end; over
the stack's two layers that is a relative RMS error of about 1e-7, so
``REL`` (1e-5) leaves a hundredfold room, while TF32's 10-bit operands
(2^-11) would break it.
"""
import math
import re

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import get_config, get_trace_config
from repro_torch.graph import (compile_graph, fuse_epilogues, interpret_graph,
                               trace_whisper_decoder, whisper_inputs)
from repro_torch.graph import execute as ex
from repro_torch.graph.trace import GELU_A, GELU_C
from repro_torch.models import whisper_block_reference as R

T, S, LAYERS = 8, 12, 2
REL = 1e-5


def rel_rms(got, want) -> float:
    got = torch.as_tensor(np.asarray(got)).double()
    return float((got - want).norm() / want.norm())


@pytest.fixture(scope="module")
def stack():
    cfg = get_trace_config("whisper-medium")
    g = trace_whisper_decoder(cfg, T, S, LAYERS)
    gen = torch.Generator().manual_seed(1234)
    params = R.init_params(cfg.d_model, cfg.d_ff, cfg.vocab_size, LAYERS, gen)
    x = torch.randn(T, cfg.d_model, generator=gen)
    xa = torch.randn(S, cfg.d_model, generator=gen)
    h, logits = R.decoder(params, x, xa, cfg.n_heads, LAYERS)
    fused, decisions = fuse_epilogues(g)
    return {"cfg": cfg, "g": g, "fused": fused, "decisions": decisions,
            "params": params, "inputs": whisper_inputs(g, params, x, xa),
            "h": h,
            "logits": logits,
            "cg": {False: compile_graph(g, use_cache=False),
                   True: compile_graph(fused, use_cache=False,
                                       decisions=decisions)}}


def test_small_config_is_the_tests_size(stack):
    cfg = stack["cfg"]
    assert (cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff, cfg.vocab_size) == \
        (32, 2, 16, 64, 64)
    assert stack["g"].outputs == (f"x{LAYERS}", "logits")


def test_interpret_graph_matches_the_reference(stack):
    ins = {k: v.numpy() for k, v in stack["inputs"].items()}
    out = interpret_graph(stack["g"], ins)
    assert rel_rms(out[f"x{LAYERS}"], stack["h"]) < REL
    assert rel_rms(out["logits"], stack["logits"]) < REL


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_executed_graph_matches_the_reference(stack, fused):
    out = stack["cg"][fused].execute(stack["inputs"], device="cpu")
    assert list(out) == [f"x{LAYERS}", "logits"]
    assert out["logits"].dtype == torch.float32
    assert rel_rms(out[f"x{LAYERS}"], stack["h"]) < REL
    assert rel_rms(out["logits"], stack["logits"]) < REL


def test_fused_and_unfused_agree_with_the_interpreter(stack):
    ins = {k: v.numpy() for k, v in stack["inputs"].items()}
    want = interpret_graph(stack["fused"], ins)
    for fused in (False, True):
        got = stack["cg"][fused].execute(stack["inputs"], device="cpu")
        for t, v in want.items():
            np.testing.assert_allclose(got[t].numpy(), v, rtol=1e-5,
                                       atol=1e-5 * np.abs(v).max())


def test_the_reference_is_whispers_layer_with_its_departures():
    """One layer by hand: no LayerNorm, tanh GELU, k without a bias."""
    gen = torch.Generator().manual_seed(5)
    D, H, F, V = 8, 2, 16, 10
    p = {k: v.double() for k, v in R.init_params(D, F, V, 1, gen).items()}
    x = torch.randn(3, D, generator=gen, dtype=torch.float64)
    xa = torch.randn(4, D, generator=gen, dtype=torch.float64)

    def attn(xq, xkv, pre, causal):
        q = xq @ p[pre + "wq"] + p[pre + "bq"]
        k = xkv @ p[pre + "wk"]
        v = xkv @ p[pre + "wv"] + p[pre + "bv"]
        heads = []
        for h in range(H):
            c = slice(4 * h, 4 * h + 4)
            s = q[:, c] @ k[:, c].T / 2.0
            if causal:
                s = s + torch.triu(torch.full_like(s, -math.inf), 1)
            heads.append(torch.softmax(s, -1) @ v[:, c])
        return torch.cat(heads, 1) @ p[pre + "wo"] + p[pre + "bo"]

    y = x + attn(x, x, "l0.sa.", True)
    y = y + attn(y, xa, "l0.ca.", False)
    f = y @ p["l0.fc1"] + p["l0.b1"]
    g = 0.5 * f * (1 + torch.tanh(GELU_C * (f + GELU_A * f ** 3)))
    y = y + g @ p["l0.fc2"] + p["l0.b2"]
    h, logits = R.decoder(p, x, xa, H, 1)
    torch.testing.assert_close(h, y, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(logits, y @ p["emb"].T, rtol=1e-12,
                               atol=1e-12)


def _per_layer(g) -> dict:
    """Node kinds by layer: ``l{l}.*`` and the layer's output ``x{l+1}``
    (with what fused into it) are layer l's, the logits the head's."""
    out: dict = {}
    for n in g.nodes:
        m = re.match(r"l(\d+)\.|x(\d+)", n.name)
        layer = ("head" if m is None else
                 f"l{m.group(1)}" if m.group(1) else f"l{int(m.group(2)) - 1}")
        kinds = out.setdefault(layer, {})
        kinds[n.kind] = kinds.get(n.kind, 0) + 1
    return out


def test_full_width_graph_nodes_per_layer():
    """whisper-medium's widths, two layers, 32 tokens over 1500 frames:
    traced and fused, not compiled."""
    g = trace_whisper_decoder(get_config("whisper-medium"), 32, 1500, 2)
    fused, decisions = fuse_epilogues(g)
    # an attention block: 16 heads of q, k, v, scores, exp, row sums,
    # weighted values and output projection, 15 head sums and the residual
    assert _per_layer(g) == {
        "l0": {"gemm": 194, "elementwise": 66, "reduce": 32},
        "l1": {"gemm": 194, "elementwise": 66, "reduce": 32},
        "head": {"gemm": 1}}
    # fused: each head's scale and exp into its scores (32 nodes), an
    # attention's head sums and residual into head 0's projection (2), GELU
    # into fc1 and the residual into fc2 (2)
    assert _per_layer(fused) == {
        "l0": {"gemm": 158, "fused": 36, "reduce": 32},
        "l1": {"gemm": 158, "fused": 36, "reduce": 32},
        "head": {"gemm": 1}}
    assert len(decisions) == 2 * 66
    assert g.tensors["logits"].shape == (32, 51865)
    assert g.tensors["l0.ca.sraw0"].shape == (32, 1500)


def _launches(monkeypatch) -> dict:
    calls = {"k1": 0, "k2": 0}

    def k1(a, b, tile=None):
        calls["k1"] += 1
        return ex_gemm(a, b, tile=tile)

    def k2(a, b, bias, fn="", tile=None):
        calls["k2"] += 1
        return ex_k2(a, b, bias, fn, tile=tile)
    ex_gemm, ex_k2 = ex.gemm, ex.gemm_bias_act
    monkeypatch.setattr(ex, "gemm", k1)
    monkeypatch.setattr(ex, "gemm_bias_act", k2)
    return calls


def _run_node(cg, name, inputs):
    env = cg.execute(inputs, device="cpu", return_all=True)
    node = cg.graph.node(name)
    return node, {buf: env[t] for buf, t in node.inputs}, env


def test_a_biased_projection_is_one_k2_launch(stack, monkeypatch):
    cg = stack["cg"][True]
    node, ins, env = _run_node(cg, "l0.f+l0.g", stack["inputs"])
    step = ex.node_steps(cg)[node.name]
    assert step.bias == "bias" and step.act == ""
    assert step.epilogue is not None        # GELU after the bias
    calls = _launches(monkeypatch)
    out = ex.run_gemm_step(step, ins)
    assert calls == {"k1": 0, "k2": 1}
    assert torch.equal(out["C"], env["l0.g"])
    q = ex.node_steps(cg)["l0.sa.q0"]
    assert q.bias == "bias" and q.epilogue is None


def test_a_relu_after_the_bias_is_k2s_activation():
    from repro_torch.core.ir import ProgramBuilder
    from repro_torch.graph.trace import matmul_bias
    prog = matmul_bias(4, 6, 5)
    pb = ProgramBuilder("relu")
    i, j = pb.axes(i=4, j=6)
    X, O = pb.buffer("X", (4, 6)), pb.buffer("O", (4, 6))
    pb.apply(O[i, j], "relu", X[i, j])
    from repro_torch.core.transforms import fuse_epilogue
    fused = fuse_epilogue(prog, pb.build(), "X")
    from repro_torch.graph import GraphBuilder
    gb = GraphBuilder("k2relu")
    for t, shape in (("a", (4, 5)), ("b", (5, 6)), ("c", (6,))):
        gb.tensor(t, shape, is_input=True)
    gb.tensor("y", (4, 6))
    gb.node("y", fused, {"A": "a", "B": "b", "bias": "c"}, {"C": "y"},
            kind="fused")
    gb.output("y")
    cg = compile_graph(gb.build(), use_cache=False)
    step = ex.node_steps(cg)["y"]
    assert (step.bias, step.act, step.epilogue) == ("bias", "relu", None)
    rng = np.random.default_rng(0)
    ins = {t: rng.standard_normal(s).astype(np.float32)
           for t, s in (("a", (4, 5)), ("b", (5, 6)), ("c", (6,)))}
    got = cg.execute(ins, device="cpu")["y"].numpy()
    np.testing.assert_allclose(got, np.maximum(ins["a"] @ ins["b"] + ins["c"],
                                               0), rtol=1e-6, atol=1e-6)


def test_a_gemm_with_an_epilogue_is_one_k1_launch_and_no_product_buffer(
        stack, monkeypatch):
    cg = stack["cg"][True]
    name = "l0.sa.sraw0+l0.sa.e0"            # q kᵀ, the scale, exp, the mask
    node, ins, env = _run_node(cg, name, stack["inputs"])
    step = ex.node_steps(cg)[name]
    assert step.bias is None and step.b == ("B", True)
    m, n, k = step.shape
    assert (m, n, k) == (T, T, 16)
    assert all(b.rank <= 2 for b in step.epilogue.buffers)
    shapes = []
    zeros = torch.zeros

    def recording(*a, **kw):
        t = zeros(*a, **kw)
        shapes.append(tuple(t.shape))
        return t
    monkeypatch.setattr(torch, "zeros", recording)
    calls = _launches(monkeypatch)
    out = ex.run_gemm_step(step, ins)
    assert calls == {"k1": 1, "k2": 0}
    assert shapes and all(len(s) <= 2 for s in shapes)
    assert torch.equal(out["C"], env["l0.sa.e0"])


def test_a_stream_node_without_a_gemm_is_interpreted(stack):
    steps = ex.node_steps(stack["cg"][True])
    assert steps["l0.sa.r0"] is None           # the row sums
    assert all(steps[n.name] is not None for n in stack["fused"].nodes
               if n.kind in ("gemm", "fused"))


def test_spans_and_counters_of_the_executor(stack):
    cg = stack["cg"][True]
    n_gemm = sum(n.kind in ("gemm", "fused") for n in cg.graph.nodes)
    # biased, by hand: q and v of each of the 2 heads and head 0's output
    # projection in each attention, fc1 and fc2, in each of the 2 layers
    n_k2 = LAYERS * (2 * (2 * 2 + 1) + 2)
    n_epi = sum(s is not None and s.epilogue is not None
                for s in ex.node_steps(cg).values())
    before = telemetry.counters()
    with telemetry.recording() as rec:
        cg.execute(stack["inputs"], device="cpu")
    after = telemetry.counters()
    diff = {k: after[k] - before[k] for k in after if k.startswith("graph.")}
    nodes = len(cg.graph.nodes)
    assert diff == {"graph.nodes": nodes, "graph.gemm_nodes": n_gemm,
                    "graph.k2_nodes": n_k2,
                    "graph.stream_nodes": nodes - n_gemm}
    spans = rec.spans()
    assert spans[0].name == "graph.execute" and spans[0].parent == -1
    assert sum(s.parent < 0 for s in spans) == 1
    names = [s.name for s in spans]
    assert names.count("graph.gemm") == n_gemm
    assert names.count("graph.epilogue") == n_epi
    assert names.count("graph.stream") == nodes - n_gemm
    for s in spans[1:]:
        parent = spans[s.parent].name
        if s.name.startswith("graph."):
            assert parent == "graph.execute", s
        elif s.name in ("k1", "k2"):
            assert parent == "graph.gemm", s


def test_the_cli_validates_the_whisper_stack(capsys):
    """``python -m repro_torch.graph --whisper-layers 2 --validate`` on the
    CPU: the trace config's stack over ``WHISPER_FRAMES`` frames, each of
    the three checks within ``WHISPER_REL``."""
    import repro_torch.graph.__main__ as graph_cli
    assert graph_cli.main(["--whisper-layers", "2", "--validate",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    ok = re.findall(r"\[ok\] (\S+): rel_rms=(\S+) \(limit", out)
    assert [name for name, _ in ok] == [
        "executed-vs-interpreted", "interpreted-vs-reference",
        "executed-vs-reference"]
    assert all(float(err) <= graph_cli.WHISPER_REL for _, err in ok)
    assert "FAIL" not in out


F32_MAX = float(np.finfo(np.float32).max)


@pytest.mark.parametrize("scale", [1.0, 4.0, 7.0, 8.0, 16.0, 64.0])
def test_where_the_softmax_without_its_row_max_overflows(stack, scale):
    """The traced softmax takes exp of the scaled scores without
    subtracting their row max (a departure, ``trace_whisper_decoder``), so
    the f32 values it makes grow with the scores: exp(s) (past a scaled
    score q·k/sqrt(hd) of log(f32 max) = 88.72 it is inf, and a masked one
    times its 0 is nan), then K1's f32 sums of exp(s) times the values,
    before the reciprocal row sum scales them down.  The stack's outputs
    are finite exactly while the largest of these stays below f32's max;
    the reference's softmax, which subtracts the row max, stays finite
    throughout.  With the prompt ``x`` scaled by 1, 4 and 7 the largest is
    13, 3.2e11 and 8.6e33; by 8 and more it overflows."""
    cg = stack["cg"][True]
    inputs = dict(stack["inputs"], x=stack["inputs"]["x"] * scale)
    env = cg.execute(inputs, device="cpu", return_all=True)
    largest = 0.0                 # the largest f32 value the softmax makes
    for n in cg.graph.nodes:      # the weighted values: A = exp(s), B = v
        if re.search(r"\.a\d+$", n.name):
            ins = dict(n.inputs)
            e, v = env[ins["A"]].double(), env[ins["B"]].double()
            for m in (e.abs().max(), (e @ v).abs().max()):
                largest = max(largest, math.inf if m.isnan() else float(m))
            if largest == math.inf:
                break
    finite = all(bool(torch.isfinite(env[t]).all()) for t in cg.graph.outputs)
    assert largest == math.inf or largest < F32_MAX / 1e3   # clear of it
    assert finite == (largest < F32_MAX) == (scale <= 7.0)
    h, logits = R.decoder(stack["params"], inputs["x"], inputs["xa"],
                          stack["cfg"].n_heads, LAYERS)
    assert bool(torch.isfinite(logits).all() and torch.isfinite(h).all())
