"""On the card only (marker ``gpu``): every CUDA kernel of the port against
its plain PyTorch version, the measured tuner's evaluator, and the slice end
to end.  Imports nothing of
JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.sysgraph import gpu_sm
from repro_torch.kernels import ref
from repro_torch.kernels.gemm import (ACTS, block_tile, device_sms, gemm,
                                      gemm_bias_act, gemm_launch, gemm_route,
                                      gemm_reduce, gemm_transpose,
                                      operand_route)
from repro_torch.kernels.gru import PARAM_NAMES, FusedGRU, gru_cell, gru_seq
from repro_torch.kernels.ops import scheduled_gemm, scheduled_gru
from repro_torch.search.evaluate import MeasuredGemmEvaluator

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
F32_TOL = TOL[torch.float32]


def rand(rng, shape):
    return rng.uniform(-1, 1, size=shape).astype(np.float32)


def to_torch(x, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def as_f32(x):
    return x.float().cpu().numpy()


def make_gru_params(rng, E, H):
    return {n: rand(rng, (E, H) if n[0] == "W" else
                    (H, H) if n[0] == "U" else (H,)) for n in PARAM_NAMES}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: on one, run PYTHONPATH=src python "
                    "-m pytest --noconftest -m gpu tests/test_torch_gpu.py")
    return torch.device("cuda")


#: tiles tried per route: small ones, whose many blocks need no split-K,
#: and large ones, which split K on the narrow shapes
ROUTE_TILES = {
    "simt": [(16, 16, 32), (64, 64, 32), (128, 128, 32), (16, 128, 32),
             (128, 16, 32)],
    "wgmma": [(64, 16, 64), (64, 64, 64), (128, 128, 64), (64, 256, 64),
              (128, 256, 64)],
}
CARD_SHAPES = [(130, 70, 190), (1, 128, 512), (512, 1, 64), (35, 700, 2048),
               (5124, 700, 2048), (7680, 1, 2560)]


def counts():
    return (gemm.launches, gemm_bias_act.launches, gemm_transpose.launches,
            gemm_reduce.launches)


def expected_launch(a, b, tile):
    """The launch a call makes, and the counts it adds: (gemm-or-K2,
    transposing passes, split-K reduces)."""
    m, k = a.shape
    launch = gemm_launch(m, b.shape[1], k, a.dtype, tile,
                         operand_route(a, b), device_sms(a.device))
    return launch, (launch.route == "wgmma", launch.split > 1)


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_gemm_kernel_on_card(cuda_device, tdt):
    tol = TOL[tdt]
    rng = np.random.default_rng(3)
    splits = set()
    for m, n, k in CARD_SHAPES:
        a = to_torch(rand(rng, (m, k)), tdt, cuda_device)
        b = to_torch(rand(rng, (k, n)), tdt, cuda_device)
        want = ref.gemm_ref(a, b)
        # f32: sums in another order than cuBLAS, error scales with |C|
        scale = float(want.abs().max()) if tdt == torch.float32 else 1.0
        route = operand_route(a, b)
        assert route is gemm_route(tdt, k)
        assert route.name == ("wgmma" if tdt == torch.bfloat16
                              and k % 8 == 0 else "simt")
        for tile in ROUTE_TILES[route.name]:
            launch, (t, r) = expected_launch(a, b, tile)
            splits.add(launch.split > 1)
            before = counts()
            got = gemm(a, b, tile=tile)
            torch.cuda.synchronize()
            assert counts() == (before[0] + 1, before[1], before[2] + t,
                                before[3] + r)
            np.testing.assert_allclose(
                as_f32(got), as_f32(want), rtol=tol["rtol"],
                atol=tol["atol"] * scale, err_msg=f"{(m, n, k)} {launch}")
    assert splits == {False, True}


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_gemm_bias_act_kernel_on_card(cuda_device, tdt):
    """K2 against its plain version: every activation at every built tile of
    the route, on ragged shapes with and without split-K, with the bias in
    f32 and in the input type."""
    tol = TOL[tdt]
    rng = np.random.default_rng(6)
    for m, n, k in [(130, 70, 190), (200, 136, 256), (35, 700, 2048)]:
        a = to_torch(rand(rng, (m, k)), tdt, cuda_device)
        b = to_torch(rand(rng, (k, n)), tdt, cuda_device)
        bias = to_torch(rand(rng, (n,)), device=cuda_device)
        scale = float((a.float() @ b.float() + bias).abs().max()) \
            if tdt == torch.float32 else 1.0
        route = operand_route(a, b)
        for fn in ACTS:
            want = ref.gemm_bias_act_ref(a, b, bias, fn)
            for tile in route.tiles():
                _, (t, r) = expected_launch(a, b, tile)
                before = counts()
                got = gemm_bias_act(a, b, bias, fn, tile=tile)
                torch.cuda.synchronize()
                assert counts() == (before[0], before[1] + 1, before[2] + t,
                                    before[3] + r)
                np.testing.assert_allclose(
                    as_f32(got), as_f32(want), rtol=tol["rtol"],
                    atol=tol["atol"] * scale, err_msg=f"{fn!r} {tile}")
            got = gemm_bias_act(a, b, bias.to(tdt), fn)
            np.testing.assert_allclose(
                as_f32(got),
                as_f32(ref.gemm_bias_act_ref(a, b, bias.to(tdt), fn)),
                rtol=tol["rtol"], atol=tol["atol"] * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_gemm_integer_inputs_bit_exact_on_card(cuda_device, tdt):
    """Integer inputs in [-4, 4] with K <= 256 make every f32 sum exact, so
    K1 and K2 (relu, integer bias) must equal the plain version bit for bit
    on both routes, split or not: a swizzle, descriptor, fragment-map or
    slice error shows as an exact mismatch, not as noise."""
    rng = np.random.default_rng(8)
    routes = set()
    for m, n, k in [(130, 70, 256), (130, 70, 250), (64, 24, 64),
                    (300, 200, 248)]:
        a = to_torch(rng.integers(-4, 5, (m, k)).astype(np.float32), tdt,
                     cuda_device)
        b = to_torch(rng.integers(-4, 5, (k, n)).astype(np.float32), tdt,
                     cuda_device)
        bias = to_torch(rng.integers(-4, 5, (n,)).astype(np.float32),
                        device=cuda_device)
        # bf16 rows at an odd element offset: 2-byte aligned, so the simt
        # route even where K % 8 == 0
        a_odd = torch.empty(m * k + 1, dtype=tdt,
                            device=cuda_device)[1:].view(m, k)
        a_odd.copy_(a)
        for x in (a, a_odd):
            route = operand_route(x, b)
            routes.add(route.name)
            for tile in ROUTE_TILES[route.name]:
                np.testing.assert_array_equal(
                    as_f32(gemm(x, b, tile=tile)), as_f32(ref.gemm_ref(x, b)),
                    err_msg=f"{route.name} {(m, n, k)} {tile}")
                np.testing.assert_array_equal(
                    as_f32(gemm_bias_act(x, b, bias, "relu", tile=tile)),
                    as_f32(ref.gemm_bias_act_ref(x, b, bias, "relu")),
                    err_msg=f"K2 {route.name} {(m, n, k)} {tile}")
    assert routes == ({"simt", "wgmma"} if tdt == torch.bfloat16
                      else {"simt"})


@pytest.mark.gpu
def test_measured_evaluator_on_card(cuda_device):
    ev = MeasuredGemmEvaluator(1024, 128, 1024, gpu_sm(8))
    configs = [{}, {"tile_i": 1024, "tile_j": 512, "tile_k": 32}]
    tiles = [ev.tile_for(c) for c in configs]
    assert tiles[0] != tiles[1]
    assert tiles == [block_tile(ev.block_for(c)) for c in configs]
    for c in configs:
        seconds = ev(c)
        assert np.isfinite(seconds) and 0 < seconds < 1


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(16, 16), (16, 32), (32, 16), (32, 32)])
def test_gru_kernels_on_card(cuda_device, tile):
    rng = np.random.default_rng(4)
    T, B, E, H = 6, 20, 72, 200
    p = {n: to_torch(v / np.sqrt(H), device=cuda_device)
         for n, v in make_gru_params(rng, E, H).items()}
    xs = to_torch(rand(rng, (T, B, E)), device=cuda_device)
    h0 = to_torch(rand(rng, (B, H)), device=cuda_device)
    cells, seqs = gru_cell.launches, gru_seq.launches
    np.testing.assert_allclose(as_f32(gru_cell(xs[0], h0, p, tile=tile)),
                               as_f32(ref.gru_cell_ref(xs[0], h0, p)),
                               **F32_TOL)
    np.testing.assert_allclose(as_f32(gru_seq(xs, h0, p, tile=tile)),
                               as_f32(ref.gru_seq_ref(xs, h0, p)),
                               rtol=1e-4, atol=1e-5)
    assert (gru_cell.launches, gru_seq.launches) == (cells + 1 + T, seqs + 1)


@pytest.mark.gpu
def test_slice_on_card(cuda_device):
    rng = np.random.default_rng(5)
    a, b = rand(rng, (192, 64)), rand(rng, (64, 160))
    got, _ = scheduled_gemm(to_torch(a, device=cuda_device),
                            to_torch(b, device=cuda_device))
    np.testing.assert_allclose(as_f32(got), a @ b, rtol=1e-5, atol=1e-4)
    p = make_gru_params(rng, 12, 24)
    xs, h0 = rand(rng, (5, 4, 12)), rand(rng, (4, 24))
    model = FusedGRU.from_numpy(p)
    got = scheduled_gru(to_torch(xs, device=cuda_device),
                        to_torch(h0, device=cuda_device), model)
    want = ref.gru_seq_ref(to_torch(xs), to_torch(h0),
                           {n: to_torch(v) for n, v in p.items()})
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=1e-4,
                               atol=1e-5)
