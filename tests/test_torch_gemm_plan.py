"""K1/K2's launch plan on the CPU: the route rule (wgmma or simt), the
split-K rule, the shared memory of every built tile, the split-K sum
against the JAX package's fused kernel, the build's cache key and the
compiler report that ``chip_smoke.py`` reads."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.gemm import gemm_bias_act as jax_gemm_bias_act
from repro.search.tune import DEEPBENCH_GEMM_SIZES
from repro_torch.kernels import cuda, ref
from repro_torch.kernels.gemm import (H100_SMS, MIN_SPLIT_STEPS, ROUTES, SIMT,
                                      WGMMA, block_tile, gemm_launch,
                                      gemm_route, operand_route, split_k)
from repro_torch.kernels.ops import MAX_SMEM_BYTES, plan_gemm

DTYPES = {"float32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-5)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16,
                       dict(rtol=2e-2, atol=2e-2))}


def rand(rng, shape):
    return rng.uniform(-1, 1, size=shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# The route rule
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("m,n,k", DEEPBENCH_GEMM_SIZES)
def test_deepbench_routes(m, n, k):
    """Every DeepBench GEMM takes wgmma in bf16 and simt in f32, through the
    plan and through the operands."""
    assert gemm_route(torch.bfloat16, k) is WGMMA
    assert gemm_route(torch.float32, k) is SIMT
    for dtype, route in ((torch.bfloat16, WGMMA), (torch.float32, SIMT)):
        cfg, _ = plan_gemm(m, n, k, dtype=dtype)
        assert cfg.route == route.name and cfg.tile in route.tiles()
        a, b = torch.empty(m, k, dtype=dtype), torch.empty(k, n, dtype=dtype)
        assert operand_route(a, b) is route


def test_route_rule_off_the_tensor_cores():
    """bf16 with K % 8 != 0 (the card tests' K = 190) or a pointer off 16
    bytes takes simt; f32 never takes wgmma."""
    assert gemm_route(torch.bfloat16, 190) is SIMT
    assert gemm_route(torch.bfloat16, 192) is WGMMA
    assert gemm_route(torch.bfloat16, 192, aligned=False) is SIMT
    assert gemm_route(torch.float32, 192) is SIMT
    a = torch.empty(130 * 192 + 1, dtype=torch.bfloat16)[1:].view(130, 192)
    assert operand_route(a, torch.empty(192, 70, dtype=torch.bfloat16)) \
        is SIMT
    assert block_tile((256, 128, 725), torch.bfloat16, 190) \
        in SIMT.tiles()
    assert block_tile((256, 128, 725), torch.bfloat16) == (64, 32, 64)


# --------------------------------------------------------------------------- #
# The split-K rule
# --------------------------------------------------------------------------- #

SPLIT_SHAPES = DEEPBENCH_GEMM_SIZES + [(130, 70, 190), (1, 128, 512),
                                       (512, 1, 64), (64, 64, 4096),
                                       (4096, 4096, 64), (35, 700, 33)]


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("m,n,k", SPLIT_SHAPES)
def test_split_rule(m, n, k, route):
    for tile in ROUTES[route].tiles():
        tiles = -(-m // tile[0]) * -(-n // tile[1])
        steps = -(-k // tile[2])
        s = split_k(m, n, k, tile)
        assert s >= 1
        if tiles >= H100_SMS:
            assert s == 1
        assert tiles * s < 2 * H100_SMS or s == 1
        slices = ref.k_slices(k, tile[2], s)
        assert slices[0][0] == 0 and slices[-1][1] == k
        for (kb, ke), (nb, _) in zip(slices, slices[1:] + [(k, k)]):
            assert ke == nb and kb < ke               # contiguous, none empty
            assert kb % tile[2] == 0
            if s > 1:
                assert -(-(ke - kb) // tile[2]) >= MIN_SPLIT_STEPS
        # with K deep enough for two slices, idle SMs always split K
        if tiles < H100_SMS and steps >= 2 * MIN_SPLIT_STEPS:
            assert s > 1


def test_split_of_the_narrow_deepbench_grids():
    """The plan tiles of the DeepBench shapes that leave SMs idle split K:
    bf16 35x700x2048 at 64x64 is 11 tiles, 8 slices."""
    cfg, _ = plan_gemm(35, 700, 2048, dtype=torch.bfloat16)
    assert (cfg.tile, cfg.grid, cfg.split) == ((64, 64, 64), (1, 11), 8)
    for m, n, k in DEEPBENCH_GEMM_SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            cfg, _ = plan_gemm(m, n, k, dtype=dtype)
            assert (cfg.split > 1) == (cfg.grid[0] * cfg.grid[1] < H100_SMS)
            assert cfg == plan_gemm(m, n, k, dtype=dtype)[0]


# --------------------------------------------------------------------------- #
# Shared memory of every built tile
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_smem_of_every_built_tile(route):
    r = ROUTES[route]
    dtypes = (torch.bfloat16,) if r is WGMMA else (torch.float32,
                                                   torch.bfloat16)
    for tile in r.tiles():
        for dtype in dtypes:
            launch = gemm_launch(1024, 1024, 1024, dtype, tile, r)
            assert launch.smem_bytes == r.smem_bytes(tile, dtype)
            assert 0 < launch.smem_bytes <= MAX_SMEM_BYTES
            bm, bn, _ = tile
            wide = bm >= 64 and bn >= 64      # an 8 x 4 register tile
            assert launch.threads == (128 * (bm // 64 + 1) if r is WGMMA
                                      else bm * bn // 32 if wide else 256)
            assert launch.threads % 32 == 0 and launch.threads <= 512
    # the largest tiles as the kernels lay them out: 3 f32 stages of a
    # 128 x (32 + 4) A panel and a 32 x 128 B panel; 4 bf16 stages of
    # (128 + 256) rows x 64, the 1024-byte alignment slack and 8 mbarriers
    assert SIMT.smem_bytes((128, 128, 32), torch.float32) \
        == 3 * 4 * (128 * 36 + 32 * 128)
    assert WGMMA.smem_bytes((128, 256, 64), torch.bfloat16) \
        == 1024 + 4 * 384 * 128 + 64


# --------------------------------------------------------------------------- #
# The split-K sum against the JAX package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["", "sigmoid", "tanh", "relu"])
@pytest.mark.parametrize("m,n,k,bk,split", [(96, 80, 64, 16, 4),
                                            (130, 70, 190, 32, 3),
                                            (35, 70, 520, 64, 8)])
def test_split_k_sum_matches_pallas(m, n, k, bk, split, fn, dtype):
    """The f32 partials of the K slices, summed in the kernel's order, then
    the epilogue: against the fused Pallas kernel in interpret mode and the
    plain versions of both packages."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(m + n + k + split)
    a, b, bias = rand(rng, (m, k)), rand(rng, (k, n)), rand(rng, (n,))
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    got = ref.gemm_bias_act_split_ref(ta, tb, torch.from_numpy(bias), fn, bk,
                                      split)
    assert got.dtype == tdt
    got = got.float().numpy()
    ja, jb = (jnp.asarray(x).astype(jdt) for x in (a, b))
    jbias = jnp.asarray(bias)
    want = jax_gemm_bias_act(ja, jb, jbias, fn=fn, block=(128, 128, 128),
                             interpret=True)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.gemm_bias_act_ref(ja, jb, jbias, fn=fn),
                        np.float32), **tol)
    np.testing.assert_allclose(
        got, ref.gemm_bias_act_ref(ta, tb, torch.from_numpy(bias),
                                   fn).float().numpy(), **tol)


def test_split_k_sum_of_integers_is_exact():
    """Integer inputs make every partial and every sum exact, so the split
    sum equals the whole product bit for bit, K1 (no bias) and K2."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-4, 5, (50, 250)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-4, 5, (250, 30)).astype(np.float32))
    bias = torch.from_numpy(rng.integers(-4, 5, (30,)).astype(np.float32))
    for split in (1, 2, 7):
        assert torch.equal(ref.gemm_bias_act_split_ref(a, b, None, "", 32,
                                                       split),
                           ref.gemm_ref(a, b))
        assert torch.equal(ref.gemm_bias_act_split_ref(a, b, bias, "relu",
                                                       32, split),
                           ref.gemm_bias_act_ref(a, b, bias, "relu"))


# --------------------------------------------------------------------------- #
# The build's cache key and the compiler's report
# --------------------------------------------------------------------------- #


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    """A changed header the source includes (directly or through another
    header) gives another library path, so the library is rebuilt."""
    monkeypatch.setattr(cuda, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cstdint>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    (tmp_path / "unrelated.cuh").write_text("// v1\n")
    assert [p.name for p in cuda.source_files("k")] == ["k.cu", "a.cuh",
                                                         "b.cuh"]
    first = cuda.library_path("k")
    (tmp_path / "unrelated.cuh").write_text("// v2\n")
    assert cuda.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// v2\n")
    second = cuda.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// edited\n')
    assert cuda.library_path("k") not in (first, second)


def test_the_gemm_library_hashes_its_header():
    assert [p.name for p in cuda.source_files("gemm")] == ["gemm.cu",
                                                            "hopper.cuh"]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111simt_kernelIfLi64ELi64ELi32EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111simt_kernelIfLi64ELi64ELi32EEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112wgmma_kernelILi64ELi64EEEvK14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112wgmma_kernelILi64ELi64EEEvK14CUtensorMap_st
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 58 registers, used 1 barriers, 656 bytes cmem[0]
"""


def test_ptxas_report_is_read_per_instantiation(monkeypatch):
    from repro_torch.kernels import gemm as gemm_mod
    report = cuda.parse_ptxas(PTXAS_LOG)
    assert len(report) == 2
    monkeypatch.setattr(gemm_mod, "ptxas_report", lambda name: report)
    assert gemm_mod.kernel_resources("simt", torch.float32, (64, 64, 32)) \
        == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
            "registers": 128}
    assert gemm_mod.kernel_resources("wgmma", torch.bfloat16, (64, 64, 64)) \
        == {"stack": 8, "spill_stores": 8, "spill_loads": 4, "registers": 58}
    assert gemm_mod.kernel_resources("simt", torch.bfloat16,
                                     (64, 64, 32)) is None
