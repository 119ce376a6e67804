"""whisper's decoder stack on the graph tier (``trace_whisper_decoder``) at a
small size on the CPU: the executed graph, fused and unfused, and the
graph interpreter against the plain float64 reference
(``models.whisper_block_reference``); the full-width graph's nodes; how the
executor runs a GEMM node with an epilogue (K1 or K2 once, no (m, n, k)
buffer); the executor's spans and counters; and, on the card only (marker
``gpu``), its CUDA graph: a replay against the eager path bit for bit.

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
from repro_torch.graph.ir import GraphError
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


def test_the_cpu_path_never_captures(stack):
    """Three ``execute(device="cpu")`` calls run the eager path each time:
    no ``graph.capture`` or ``graph.replay`` counted, no ``Replay`` kept,
    the same outputs."""
    cg = stack["cg"][True]
    before = telemetry.counters()
    outs = [cg.execute(stack["inputs"], device="cpu") for _ in range(3)]
    after = telemetry.counters()
    assert after.get("graph.capture", 0) == before.get("graph.capture", 0)
    assert after.get("graph.replay", 0) == before.get("graph.replay", 0)
    assert after["graph.nodes"] - before["graph.nodes"] == \
        3 * len(cg.graph.nodes)
    assert cg.replays == {}
    for out in outs[1:]:
        assert list(out) == list(outs[0])
        for t, v in out.items():
            assert torch.equal(v, outs[0][t]), t


def test_a_replay_copies_only_what_changed(stack):
    """``_copy_in``'s rule, on CPU tensors: an input is copied into its
    static tensor unless it is the tensor object copied last and its
    ``_version`` has not moved; a new object, an in-place change (through
    a view too) and an array are copied."""
    g = stack["fused"]
    rep = ex.Replay(inputs={t: torch.zeros(g.tensors[t].shape)
                            for t in g.inputs})
    inputs = dict(stack["inputs"])
    ex._copy_in(rep, g, inputs)
    for t in g.inputs:
        assert torch.equal(rep.inputs[t], inputs[t]), t
    marks = {t: v.clone() for t, v in rep.inputs.items()}
    for v in rep.inputs.values():
        v.fill_(-1.0)              # what a copy would overwrite
    ex._copy_in(rep, g, inputs)    # the same objects, unchanged: no copy
    assert all(bool((v == -1.0).all()) for v in rep.inputs.values())
    w = next(t for t in g.inputs if t.startswith("l0."))
    inputs["x"] = inputs["x"].clone()                  # a new object
    inputs[w] = inputs[w].clone()
    inputs[w][:1].add_(1.0)                            # through a view
    inputs["xa"] = inputs["xa"].numpy()                # an array
    ex._copy_in(rep, g, inputs)
    for t in g.inputs:
        copied = not bool((rep.inputs[t] == -1.0).all())
        assert copied == (t in ("x", "xa", w)), t
    assert torch.equal(rep.inputs[w], inputs[w])
    assert torch.equal(rep.inputs["x"], marks["x"])
    inputs[w].mul_(2.0)                                # in place
    ex._copy_in(rep, g, inputs)
    assert torch.equal(rep.inputs[w], inputs[w])
    with pytest.raises(GraphError, match="shape"):
        ex._copy_in(rep, g, dict(inputs, x=torch.zeros(1, 1)))
    with pytest.raises(GraphError, match="missing"):
        ex._copy_in(rep, g, {t: v for t, v in inputs.items() if t != "xa"})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: on one, run PYTHONPATH=src python "
                    "-m pytest --noconftest -m gpu "
                    "tests/test_torch_whisper_block.py")
    return torch.device("cuda", torch.cuda.current_device())


def _card_stack(size: str, device):
    """The small stack of the CPU tests (T 8, 12 frames, 2 layers) or one
    layer of whisper-medium at its published widths (T 32, 1500 frames),
    compiled, and two input sets on ``device`` that share the weights."""
    cfg, T, S, layers = ((get_trace_config("whisper-medium"), 8, 12, 2)
                         if size == "small" else
                         (get_config("whisper-medium"), 32, 1500, 1))
    g, decisions = fuse_epilogues(trace_whisper_decoder(cfg, T, S, layers))
    cg = compile_graph(g, use_cache=False, decisions=decisions)
    gen = torch.Generator(device=device).manual_seed(0)
    params = R.init_params(cfg.d_model, cfg.d_ff, cfg.vocab_size, layers,
                           gen, device)
    sets = []
    for _ in range(2):
        x = torch.randn(T, cfg.d_model, generator=gen, device=device)
        xa = torch.randn(S, cfg.d_model, generator=gen, device=device)
        sets.append(whisper_inputs(g, params, x, xa))
        params = sets[-1]
    return cg, sets


def _counted(fn):
    """What ``fn`` returns, and how far it moved each counter."""
    before = telemetry.counters()
    out = fn()
    torch.cuda.synchronize()
    after = telemetry.counters()
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}


def _eager(cg, inputs):
    """The eager path's outputs (``return_all`` never captures)."""
    env = cg.execute(inputs, return_all=True)
    return {t: env[t] for t in cg.graph.outputs}


def _same(got, want) -> bool:
    return list(got) == list(want) and all(torch.equal(v, want[t])
                                           for t, v in got.items())


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["small", "full"])
def test_a_replay_gives_the_eager_bits_on_card(cuda_device, size):
    """Calls 1 (eager), 2 (capture) and 3 on (replay) on two input sets
    give the eager path's outputs bit for bit; a returned output is not
    overwritten by a later call; an in-place change to a weight shows in
    the next replay, equal to an eager run with it; each call advances
    the executor's and K1/K2's launch counters as an eager call does, with
    one ``graph.capture`` and n - 2 ``graph.replay``; ``return_all`` never
    captures."""
    cg, (one, two) = _card_stack(size, cuda_device)
    want = [_eager(cg, one), _eager(cg, two)]
    assert cg.replays == {}
    _, eager_counts = _counted(lambda: cg.execute(one))
    assert set(eager_counts) >= {"graph.nodes", "gemm.launches"}
    rep = cg.replays[cuda_device]
    assert rep.runs == 1 and rep.graph is None
    outs, calls = [], 0
    for inputs, w in ((two, want[1]), (one, want[0]), (two, want[1]),
                      (two, want[1]), (one, want[0])):
        out, counts = _counted(lambda: cg.execute(inputs))
        calls += 1
        kind = "graph.capture" if calls == 1 else "graph.replay"
        assert counts == {**eager_counts, kind: 1}, calls
        assert _same(out, w), calls
        outs.append((out, {t: v.clone() for t, v in out.items()}))
    assert rep.graph is not None
    for out, kept in outs:                 # no output aliases another
        assert _same(out, kept)
    w = next(t for t in cg.graph.inputs if t.startswith("l0.") and
             t.endswith("wk0"))
    one[w].mul_(0.5)                       # shared by both input sets
    assert _same(cg.execute(two), _eager(cg, two))
    assert not _same(_eager(cg, two), want[1])
    _, counts = _counted(lambda: [cg.execute(one, return_all=True)
                                  for _ in range(3)])
    assert "graph.capture" not in counts and "graph.replay" not in counts


@pytest.mark.gpu
def test_return_all_never_captures_on_card(cuda_device):
    cg, (one, _) = _card_stack("small", cuda_device)
    _, counts = _counted(lambda: [cg.execute(one, return_all=True)
                                  for _ in range(3)])
    assert "graph.capture" not in counts and "graph.replay" not in counts
    assert counts["graph.nodes"] == 3 * len(cg.graph.nodes)
    assert cg.replays == {}


@pytest.mark.gpu
def test_spans_of_the_capture_and_the_replay_on_card(cuda_device):
    """Call 2 records ``graph.capture`` below ``graph.execute`` with the
    node loop's spans below it; call 3 ``graph.replay`` and no node span."""
    cg, (one, two) = _card_stack("small", cuda_device)
    cg.execute(one)
    for inputs, kind in ((two, "graph.capture"), (one, "graph.replay")):
        with telemetry.recording() as rec:
            cg.execute(inputs)
        spans = rec.spans()
        assert spans[0].name == "graph.execute" and spans[0].parent == -1
        assert spans[1].name == kind and spans[1].parent == 0
        names = {s.name for s in spans}
        if kind == "graph.replay":
            assert names == {"graph.execute", "graph.replay"}
        else:
            assert {"graph.gemm", "graph.stream"} <= names
            assert all(s.parent >= 1 for s in spans[2:])


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
