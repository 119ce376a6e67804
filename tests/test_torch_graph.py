"""The port's graph tier (``repro_torch.graph``, ``models``, ``configs`` and
``verify.graph``) against the JAX package's, on the CPU.

Graphs, fusion decisions, compiled artifacts (on ``tpu_v5e(1)`` and on the
port's target, ``gpu_sm(8)``), placements and verifier reports are equal to
the JAX package's, modulo the toolchain version in the artifact keys.
Execution is held bit for bit: ``CompiledGraph.execute(device="cpu")`` runs
the card's dispatch (K1 for ``pallas_gpu_gemm`` nodes, ``interpret_program``
for the rest) on the plain versions, against the JAX package's executor
replay and ``interpret_graph``, on the tracer's ternary inputs, where every
sum is exact in any order.  ``interpret_program`` on the GRU chain's
programs (sigmoid, tanh; non-integer inputs) agrees with NumPy's
``interpret`` within 1 f32 ulp after the output cast, since its sums take
another order and its exp is torch's.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.ir import interpret as jax_interpret
from repro.core.sysgraph import gpu_sm as jax_gpu_sm
from repro.core.sysgraph import tpu_v5e as jax_tpu_v5e
from repro.graph import compile_graph as jax_compile_graph
from repro.graph import fuse_epilogues as jax_fuse_epilogues
from repro.graph import interpret_graph as jax_interpret_graph
from repro.graph import plan_placement as jax_plan_placement
from repro.graph import trace_block as jax_trace_block
from repro.graph import trace_gru_chain as jax_trace_gru_chain
from repro.verify import verify_graph as jax_verify_graph
from repro.verify import verify_placement as jax_verify_placement
from repro_torch.compile import ArtifactCache, CompileError
from repro_torch.compile.driver import clear_memo
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs import get_trace_config
from repro_torch.core import kernels_ir
from repro_torch.core.ir import UNARY_FNS, IRError, ProgramBuilder, interpret
from repro_torch.core.sysgraph import gpu_sm, tpu_v5e
from repro_torch.graph import (CompiledGraph, GraphError, KernelGraph,
                               assert_exactness_bound, block_inputs,
                               compile_graph, edge_bytes, fuse_epilogues,
                               interpret_graph, interpret_program,
                               plan_placement, trace_block, trace_gru_chain)
from repro_torch.graph.execute import TORCH_UNARY_FNS, gemm_operands
from repro_torch.graph.trace import matmul_nt
from repro_torch.kernels.gemm import gemm
from repro_torch.models.traceable import block_reference
from repro_torch.verify import verify_graph, verify_placement

SEQ = 8
TARGETS = {"tpu_v5e": (lambda: tpu_v5e(1), lambda: jax_tpu_v5e(1)),
           "gpu_sm": (lambda: gpu_sm(8), lambda: jax_gpu_sm(8))}


def traced(arch: str, fused: bool):
    """(port graph, port decisions, JAX graph, JAX decisions)."""
    g = trace_block(get_trace_config(arch), seq_len=SEQ)
    ref = jax_trace_block(jax_registry.get_trace_config(arch), seq_len=SEQ)
    if not fused:
        return g, [], ref, []
    return (*fuse_epilogues(g), *jax_fuse_epilogues(ref))


def without_version(d):
    """A ``to_dict`` payload with the toolchain version cut from every
    artifact key (``|torch=...`` in the port, ``|jax=...`` in JAX)."""
    if isinstance(d, dict):
        return {k: (v.rsplit("|", 1)[0] if k == "key" else without_version(v))
                for k, v in d.items()}
    if isinstance(d, list):
        return [without_version(v) for v in d]
    return d


@pytest.fixture(scope="module")
def whisper():
    """whisper-medium's trace-config block, unfused and fused, compiled on
    the port's target, with its oracle inputs."""
    cfg = get_trace_config("whisper-medium")
    g = trace_block(cfg, seq_len=SEQ)
    fg, decisions = fuse_epilogues(g)
    return {"cfg": cfg, "unfused": g, "fused": fg,
            "cg_unfused": compile_graph(g, gpu_sm(8), use_cache=False),
            "cg_fused": compile_graph(fg, gpu_sm(8), use_cache=False,
                                      decisions=decisions),
            "inputs": block_inputs(g)}


# --------------------------------------------------------------------------- #
# Configs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_package(arch):
    assert ARCHS == jax_registry.ARCHS
    for port, ref in ((get_config, jax_registry.get_config),
                      (get_smoke_config, jax_registry.get_smoke_config),
                      (get_trace_config, jax_registry.get_trace_config)):
        assert dataclasses.asdict(port(arch)) == dataclasses.asdict(ref(arch))
    assert get_config(arch).activation_dtype == torch.bfloat16


# --------------------------------------------------------------------------- #
# Tracing and fusion
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_and_fusion_match_jax_package(arch, fused):
    g, decisions, ref, ref_decisions = traced(arch, fused)
    assert g.fingerprint() == ref.fingerprint()
    assert g.to_dict() == ref.to_dict()
    assert [d.to_dict() for d in decisions] == \
        [d.to_dict() for d in ref_decisions]
    assert edge_bytes(g) == (edge_bytes(traced(arch, False)[0])
                             - sum(d.saved_bytes for d in decisions))


def test_gru_chain_matches_jax_package():
    assert trace_gru_chain().to_dict() == jax_trace_gru_chain().to_dict()


def test_graph_json_round_trip(whisper):
    g = whisper["unfused"]
    rt = KernelGraph.from_dict(json.loads(json.dumps(g.to_dict())))
    assert rt.fingerprint() == g.fingerprint()


def test_validate_and_trace_reject_malformed_graphs(whisper):
    g = KernelGraph.from_dict(whisper["unfused"].to_dict())
    g.nodes = (g.nodes[-1],) + g.nodes[:-1]
    with pytest.raises(GraphError):
        g.validate()
    with pytest.raises(GraphError):
        trace_block(whisper["cfg"].scaled(n_heads=4, head_dim=8), seq_len=SEQ)


# --------------------------------------------------------------------------- #
# Compilation
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("target", sorted(TARGETS))
@pytest.mark.parametrize("arch", ["whisper-medium", "olmo-1b", "xlstm-1.3b"])
def test_compiled_graph_matches_jax_package(arch, target, fused):
    g, decisions, ref, ref_decisions = traced(arch, fused)
    port_graph, jax_graph = TARGETS[target]
    cg = compile_graph(g, port_graph(), use_cache=False, decisions=decisions)
    jcg = jax_compile_graph(ref, jax_graph(), use_cache=False,
                            decisions=ref_decisions)
    assert without_version(cg.to_dict()) == without_version(jcg.to_dict())


def test_gru_chain_compiles_once_like_jax_package():
    cg = compile_graph(trace_gru_chain(), use_cache=False)
    ref = jax_compile_graph(jax_trace_gru_chain(), jax_gpu_sm(8),
                            use_cache=False)
    assert without_version(cg.to_dict()) == without_version(ref.to_dict())
    assert cg.stats["nodes"] == 4 and cg.stats["unique_programs"] == 1


def test_default_target_is_the_ports(whisper):
    cg = compile_graph(whisper["unfused"], use_cache=False)
    assert {k.graph_name for k in cg.kernels.values()} == {"gpu_sm_x8"}
    kinds = {k.lowering["kind"] for k in cg.kernels.values()}
    assert kinds == {"pallas_gpu_gemm", "stream"}
    rt = CompiledGraph.from_dict(cg.to_dict())
    rt.ensure_kernels(use_cache=False)
    assert all(k.graph_name == "gpu_sm_x8" for k in rt.kernels.values())


def test_second_compile_is_all_cache_hits(whisper, tmp_path):
    g = whisper["fused"]
    path = os.fspath(tmp_path / "arts.json")
    cold = compile_graph(g, cache=ArtifactCache(path))
    assert cold.stats["fresh_compiles"] == cold.stats["unique_programs"]
    clear_memo()
    warm = compile_graph(g, cache=ArtifactCache(path))
    assert warm.stats["fresh_compiles"] == 0
    assert warm.stats["cache_hits"] == warm.stats["unique_programs"]
    assert warm.makespan == cold.makespan
    assert len(ArtifactCache(path)) == warm.stats["unique_programs"]


# --------------------------------------------------------------------------- #
# Placement and the graph verifier
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("budget", [1 << 26, 1024, 4096])
def test_placement_matches_jax_package(whisper, budget):
    g = whisper["unfused"]
    pl = plan_placement(g, budget)
    ref = jax_plan_placement(traced("whisper-medium", False)[2], budget)
    assert pl.to_dict() == ref.to_dict()
    assert pl.peak_vmem <= pl.budget
    assert bool(pl.spilled()) == (budget < 1 << 26)


def test_spilling_costs_makespan_and_hbm(whisper):
    spilled = compile_graph(whisper["unfused"], gpu_sm(8), use_cache=False,
                            vmem_budget=1024)
    assert spilled.placement.spilled()
    assert spilled.makespan > whisper["cg_unfused"].makespan
    assert spilled.hbm_bytes > whisper["cg_unfused"].hbm_bytes


def _diags(ds):
    return [(d.rule, d.severity, d.subject, d.message) for d in ds]


def test_verify_graph_and_placement_match_jax_package(whisper):
    g = whisper["unfused"]
    ref = traced("whisper-medium", False)[2]
    assert verify_graph(g) == [] and jax_verify_graph(ref) == []
    pl = plan_placement(g, 1 << 26)
    assert verify_placement(g, pl.locations, pl.budget) == []
    bad = {t: "vmem" for t in pl.locations}
    bad[sorted(bad)[0]] = "l2"
    diags = verify_placement(g, bad, 1)
    assert {d.rule for d in diags} == {"gra.capacity"}
    assert _diags(diags) == _diags(jax_verify_placement(ref, bad, 1))


def test_verify_graph_reports_a_corrupted_graph_like_jax(whisper):
    from repro.graph import GraphNode as JaxGraphNode
    from repro.graph import KernelGraph as JaxKernelGraph
    from repro.graph import TensorSpec as JaxTensorSpec
    from repro_torch.graph import GraphNode, TensorSpec
    d = whisper["unfused"].to_dict()
    g, ref = (
        graph_cls(d["name"],
                  {t["name"]: spec_cls.from_dict(t) for t in d["tensors"]},
                  tuple(node_cls.from_dict(n) for n in d["nodes"][::-1]),
                  tuple(d["inputs"]), ("nowhere",))
        for graph_cls, node_cls, spec_cls in (
            (KernelGraph, GraphNode, TensorSpec),
            (JaxKernelGraph, JaxGraphNode, JaxTensorSpec)))
    diags = verify_graph(g)
    assert {"gra.cycle", "gra.unknown-tensor"} <= {x.rule for x in diags}
    assert _diags(diags) == _diags(jax_verify_graph(ref))


# --------------------------------------------------------------------------- #
# interpret_program against core.ir.interpret
# --------------------------------------------------------------------------- #


def test_unary_fns_are_the_cores():
    assert TORCH_UNARY_FNS.keys() == UNARY_FNS.keys()
    x = np.linspace(-3.0, 3.0, 60)
    for name, fn in UNARY_FNS.items():
        got = TORCH_UNARY_FNS[name](torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, fn(x), rtol=1e-15, atol=0, err_msg=name)


def _node_cases():
    """(node, its inputs in the oracle run) for every distinct program of
    the trace-config block, unfused and fused."""
    cases = {}
    for fused in (False, True):
        g = traced("whisper-medium", fused)[0]
        env = interpret_graph(g, block_inputs(g), return_all=True)
        for node in g.nodes:
            cases.setdefault(node.program.name,
                             (node, {b: env[t] for b, t in node.inputs}))
    return sorted(cases.items())


NODE_CASES = _node_cases()


@pytest.mark.parametrize("name,case", NODE_CASES,
                         ids=[n for n, _ in NODE_CASES])
def test_interpret_program_bit_exact_on_trace_programs(name, case):
    node, ins = case
    got = interpret_program(node.program, ins, device="cpu")
    want = interpret(node.program, ins)
    jax_want = jax_interpret(node.program, ins)
    assert set(got) == set(want) == set(jax_want)
    for buf, arr in want.items():
        assert got[buf].dtype == torch.float32
        assert np.array_equal(got[buf].numpy(), arr), buf
        assert np.array_equal(got[buf].numpy(), jax_want[buf]), buf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interpret_program_within_one_ulp_on_gru_programs(seed):
    prog = trace_gru_chain().nodes[0].program
    rng = np.random.default_rng(seed)
    ins = {b.name: rng.uniform(-1, 1, b.shape).astype(np.float32)
           for b in prog.buffers if not b.temp and b.name != "Hout"}
    got = interpret_program(prog, ins, device="cpu")["Hout"].numpy()
    np.testing.assert_array_max_ulp(got, interpret(prog, ins)["Hout"],
                                    maxulp=1)


def test_interpret_program_ops_and_last_write():
    pb = ProgramBuilder("ops")
    i, j = pb.axes(i=3, j=4)
    X = pb.buffer("X", (3, 4))
    S = pb.buffer("S", (3,))
    P = pb.buffer("P", (3,))
    M = pb.buffer("M", (3,))
    L = pb.buffer("L", (3,))
    pb.stmt(S[i], "+=", X[i, j])
    pb.stmt(S[i], "-=", X[i, 0])
    pb.stmt(P[i], ":=", X[i, 0])
    pb.stmt(P[i], "*=", X[i, j])
    pb.stmt(M[i], "max=", X[i, j])
    pb.stmt(L[i], ":=", X[i, j])
    pb.apply(L[i], "neg", L[i])
    for b in ("S", "P", "M", "L"):
        pb.output(b)
    prog = pb.build()
    x = np.arange(1, 13, dtype=np.float32).reshape(3, 4)
    got = interpret_program(prog, {"X": x}, device="cpu")
    for b, arr in interpret(prog, {"X": x}).items():
        assert np.array_equal(got[b].numpy(), arr), b
    assert got["L"].tolist() == [-4.0, -8.0, -12.0]


def test_interpret_program_refuses_overlapping_writes():
    pb = ProgramBuilder("overlap")
    i, k = pb.axes(i=4, k=3)
    X = pb.buffer("X", (4, 3))
    O = pb.buffer("O", (6,))
    pb.stmt(O[i + k], "+=", X[i, k])
    pb.output("O")
    with pytest.raises(IRError):
        interpret_program(pb.build(), {"X": np.ones((4, 3))}, device="cpu")


# --------------------------------------------------------------------------- #
# The torch reference and execution on the CPU
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCHS)
def test_block_reference_bit_exact_against_interpret_graph(arch):
    cfg = get_trace_config(arch)
    g, _, ref_g, _ = traced(arch, False)
    inputs = block_inputs(g)
    env = interpret_graph(g, inputs, return_all=True)
    jax_env = jax_interpret_graph(ref_g, inputs, return_all=True)
    ref = block_reference(inputs, cfg, SEQ, device="cpu", return_all=True)
    assert set(ref) == set(env) - {t for t in g.inputs if t != "x"}
    for t, arr in ref.items():
        assert np.array_equal(arr.numpy(), env[t]), t
        assert np.array_equal(arr.numpy(), jax_env[t]), t
    y2 = block_reference(inputs, cfg, SEQ, device="cpu")
    assert y2.dtype == torch.float32 and torch.equal(y2, ref["y2"])
    assert 0 < assert_exactness_bound(env) < float(1 << 24)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_execute_bit_exact_against_jax_package(arch, fused):
    g, decisions, ref_g, ref_decisions = traced(arch, fused)
    inputs = block_inputs(g)
    cg = compile_graph(g, gpu_sm(8), use_cache=False, decisions=decisions)
    jcg = jax_compile_graph(ref_g, jax_gpu_sm(8), use_cache=False,
                            decisions=ref_decisions)
    got = cg.execute(inputs, device="cpu", return_all=True)
    oracle = jax_interpret_graph(ref_g, inputs, return_all=True)
    assert set(got) == set(oracle)
    for t, arr in oracle.items():
        assert got[t].device.type == "cpu" and got[t].dtype == torch.float32
        assert np.array_equal(got[t].numpy(), arr), t
    out = cg.execute(inputs, device="cpu")
    assert list(out) == ["y2"]
    assert np.array_equal(out["y2"].numpy(), jcg.execute(inputs)["y2"])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_execute_after_from_dict_without_ensure_kernels(whisper, fused):
    cg = whisper["cg_fused" if fused else "cg_unfused"]
    rt = CompiledGraph.from_dict(json.loads(json.dumps(cg.to_dict())))
    assert all(k.schedule is None for k in rt.kernels.values())
    inputs = whisper["inputs"]
    want = cg.execute(inputs, device="cpu")["y2"]
    got = rt.execute({t: torch.from_numpy(v) for t, v in inputs.items()},
                     device="cpu")["y2"]
    assert torch.equal(got, want)
    ref = block_reference(inputs, whisper["cfg"], SEQ, device="cpu")
    assert torch.equal(got, ref)


def test_execute_launches_k1_once_per_gemm_node(whisper):
    for key in ("cg_unfused", "cg_fused"):
        cg = whisper[key]
        gemm_nodes = sum(cg.kernels[cg.node_kernels[n.name]].lowering["kind"]
                         == "pallas_gpu_gemm" for n in cg.graph.nodes)
        assert gemm_nodes == {"cg_unfused": 15, "cg_fused": 10}[key]


def test_matmul_nt_node_gives_q_times_k_transposed():
    prog = matmul_nt(3, 5, 4)
    (a, a_t), (b, b_t), mnk = gemm_operands(prog)
    assert (a, a_t, b, b_t, mnk) == ("A", False, "B", True, (3, 5, 4))
    assert gemm_operands(kernels_ir.matmul(3, 5, 4)) == \
        (("A", False), ("B", False), (3, 5, 4))
    from repro_torch.graph import GraphBuilder
    gb = GraphBuilder("nt")
    gb.tensor("q", (3, 4), is_input=True)
    gb.tensor("k", (5, 4), is_input=True)
    gb.tensor("s", (3, 5))
    gb.node("s", prog, {"A": "q", "B": "k"}, {"C": "s"}, kind="gemm")
    gb.output("s")
    cg = compile_graph(gb.build(), use_cache=False)
    assert cg.kernels[cg.node_kernels["s"]].lowering["kind"] == \
        "pallas_gpu_gemm"
    rng = np.random.default_rng(0)
    q = rng.integers(-3, 4, (3, 4)).astype(np.float32)
    k = rng.integers(-3, 4, (5, 4)).astype(np.float32)
    before = gemm.launches
    s = cg.execute({"q": q, "k": k}, device="cpu")["s"].numpy()
    assert gemm.launches == before            # the CPU takes the plain path
    assert np.array_equal(s, q @ k.T)


def test_gemm_operands_refuses_other_programs():
    with pytest.raises(GraphError):
        gemm_operands(kernels_ir.gru_cell(2, 4, 4))


def test_execute_needs_a_card_unless_asked_for_the_cpu(whisper, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        whisper["cg_unfused"].execute(whisper["inputs"])
    with pytest.raises(RuntimeError):
        block_reference(whisper["inputs"], whisper["cfg"], SEQ)


def test_execute_refuses_a_tpu_lowering(whisper):
    cg = compile_graph(whisper["unfused"], tpu_v5e(1), use_cache=False)
    with pytest.raises(CompileError):
        cg.execute(whisper["inputs"], device="cpu")


def test_execute_checks_its_inputs(whisper):
    inputs = dict(whisper["inputs"])
    inputs.pop("x")
    with pytest.raises(GraphError):
        whisper["cg_unfused"].execute(inputs, device="cpu")
    inputs["x"] = np.zeros((3, 3), np.float32)
    with pytest.raises(GraphError):
        whisper["cg_unfused"].execute(inputs, device="cpu")

