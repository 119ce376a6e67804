"""The port's compiler tier against the JAX package's: on the modeled GPU
(``gpu_sm(8)``) both produce identical artifacts for the DeepBench GEMMs
(paper Fig. 3), the GRU sizes (paper Fig. 4) and ResNet-50's stride-1
pointwise convolutions at batch 28 (paper Fig. 5)."""
import pytest

from repro.compile import compile_conv as jax_compile_conv
from repro.compile import compile_gemm as jax_compile_gemm
from repro.compile import compile_gru as jax_compile_gru
from repro.core.sysgraph import gpu_sm as jax_gpu_sm
from repro.search.tune import DEEPBENCH_GEMM_SIZES
from repro_torch.compile import compile_conv, compile_gemm, compile_gru
from repro_torch.compile.keys import artifact_key, torch_version
from repro_torch.core import kernels_ir
from repro_torch.core.sysgraph import TARGETS, gpu_sm, resolve_target
from repro_torch.models.resnet50_1x1_reference import pointwise_convs

#: the 12 distinct (h, w, cin, cout) of ResNet-50's 33 stride-1 1x1 convs
RESNET_1X1 = list(dict.fromkeys((c["h"], c["w"], c["cin"], c["cout"])
                                for c in pointwise_convs()))

FIELDS = ("lowering", "cost", "counts", "bytes_moved", "program_fp",
          "graph_fp", "program_name", "graph_name", "approach_fp")


def assert_same_artifact(port, ref):
    for f in FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert [p.to_dict() for p in port.instrs] == \
        [p.to_dict() for p in ref.instrs]


@pytest.mark.parametrize("m,n,k", DEEPBENCH_GEMM_SIZES)
def test_gemm_artifact_matches_jax_package(m, n, k):
    port = compile_gemm(m, n, k, graph=gpu_sm(8), use_cache=False)
    ref = jax_compile_gemm(m, n, k, graph=jax_gpu_sm(8), use_cache=False)
    assert_same_artifact(port, ref)
    assert port.lowering["kind"] == "pallas_gpu_gemm"


@pytest.mark.parametrize("batch,hidden", [(16, 256), (32, 512), (32, 1792)])
def test_gru_artifact_matches_jax_package(batch, hidden):
    port = compile_gru(batch, hidden, graph=gpu_sm(8), use_cache=False)
    ref = jax_compile_gru(batch, hidden, graph=jax_gpu_sm(8),
                          use_cache=False)
    assert_same_artifact(port, ref)


@pytest.mark.parametrize("h,w,cin,cout", RESNET_1X1)
def test_resnet_1x1_conv_artifact_matches_jax_package(h, w, cin, cout):
    """The plan ``ops.plan_conv`` reads is the JAX package's: the whole
    artifact but ``meta`` and the key's toolchain part."""
    kw = dict(batch=28, h=h, w=w, kh=1, kw=1, cin=cin, cout=cout)
    port = compile_conv(graph=gpu_sm(8), use_cache=False, **kw)
    ref = jax_compile_conv(graph=jax_gpu_sm(8), use_cache=False, **kw)
    assert_same_artifact(port, ref)
    payload = lambda art: {k: v for k, v in art.to_dict().items()
                           if k not in ("meta", "key")}
    assert payload(port) == payload(ref)
    assert port.key.rpartition("|")[0] == ref.key.rpartition("|")[0]
    assert port.instr_plan("mxu.matmul").calls == 1


def test_memo_hit_replays_the_fresh_compile():
    fresh = compile_gemm(96, 64, 80, use_cache=False)
    compile_gemm(96, 64, 80)
    hit = compile_gemm(96, 64, 80)
    assert hit.from_cache and not fresh.from_cache
    payload = lambda art: {k: v for k, v in art.to_dict().items()
                           if k != "meta"}
    assert payload(hit) == payload(fresh)
    assert hit.ensure_schedule().makespan == fresh.cost


def test_key_names_the_port_toolchain_and_target():
    key = artifact_key(kernels_ir.matmul(64, 64, 64), gpu_sm(8), None)
    assert key.endswith(f"|torch={torch_version()}")
    assert "gpu_sm_x8@" in key
    assert set(TARGETS) == {"gpu_sm", "tpu_v5e", "paper"}
    assert resolve_target("gpu").name == "gpu_sm_x8"
