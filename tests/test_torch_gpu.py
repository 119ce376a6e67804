"""On the card only (marker ``gpu``): every CUDA kernel of the port against
its plain PyTorch version, the measured tuner's evaluator, and the slice end
to end.  Imports nothing of
JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.sysgraph import gpu_sm
from repro_torch.kernels import ref
from repro_torch.kernels.gemm import (ACTS, DEFAULT_TILE, TILE_K, TILE_MN,
                                      block_tile, gemm, gemm_bias_act)
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


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_gemm_kernel_on_card(cuda_device, tdt):
    tol = TOL[tdt]
    rng = np.random.default_rng(3)
    before = gemm.launches
    tiles = [(16, 16, 16), DEFAULT_TILE, (128, 128, 32), (16, 128, 16)]
    for m, n, k in [(130, 70, 190), (1, 128, 512), (512, 1, 64),
                    (35, 700, 2048)]:
        a = to_torch(rand(rng, (m, k)), tdt, cuda_device)
        b = to_torch(rand(rng, (k, n)), tdt, cuda_device)
        want = ref.gemm_ref(a, b)
        # f32: sums in another order than cuBLAS, error scales with |C|
        scale = float(want.abs().max()) if tdt == torch.float32 else 1.0
        for tile in tiles:
            got = gemm(a, b, tile=tile)
            torch.cuda.synchronize()
            np.testing.assert_allclose(
                as_f32(got), as_f32(want), rtol=tol["rtol"],
                atol=tol["atol"] * scale)
    assert gemm.launches == before + 4 * len(tiles)


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_gemm_bias_act_kernel_on_card(cuda_device, tdt):
    """K2 against its plain version: every activation at every built tile,
    on a ragged shape, with the bias in f32 and in the input type."""
    tol = TOL[tdt]
    rng = np.random.default_rng(6)
    m, n, k = 130, 70, 190
    a = to_torch(rand(rng, (m, k)), tdt, cuda_device)
    b = to_torch(rand(rng, (k, n)), tdt, cuda_device)
    bias = to_torch(rand(rng, (n,)), device=cuda_device)
    scale = float((a.float() @ b.float() + bias).abs().max()) \
        if tdt == torch.float32 else 1.0
    tiles = list(itertools.product(TILE_MN, TILE_MN, TILE_K))
    before = gemm_bias_act.launches
    for fn in ACTS:
        want = ref.gemm_bias_act_ref(a, b, bias, fn)
        for tile in tiles:
            got = gemm_bias_act(a, b, bias, fn, tile=tile)
            torch.cuda.synchronize()
            np.testing.assert_allclose(
                as_f32(got), as_f32(want), rtol=tol["rtol"],
                atol=tol["atol"] * scale, err_msg=f"{fn!r} {tile}")
        got = gemm_bias_act(a, b, bias.to(tdt), fn)
        np.testing.assert_allclose(
            as_f32(got),
            as_f32(ref.gemm_bias_act_ref(a, b, bias.to(tdt), fn)),
            rtol=tol["rtol"], atol=tol["atol"] * scale)
    assert gemm_bias_act.launches == before + len(ACTS) * (len(tiles) + 1)


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
