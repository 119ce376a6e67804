"""The bridge from the compiler's plan to the CUDA launches, and where the
port's entry points run: on the card unless the caller asks for the CPU."""
import numpy as np
import pytest
import torch

from repro.search.tune import DEEPBENCH_GEMM_SIZES
from repro_torch.compile import CompileError, compile_gemm
from repro_torch.core.sysgraph import gpu_sm
from repro_torch import telemetry
from repro_torch.kernels import cuda
from repro_torch.kernels.gemm import (ROUTES, gemm, gemm_bias_act,
                                      gemm_route, split_k)
from repro_torch.kernels.gru import (PARAM_NAMES, TILE_B, TILE_H, FusedGRU,
                                     gru_cell, gru_seq)
from repro_torch.kernels.ops import (MAX_SMEM_BYTES, gru_tile, launch_config,
                                     plan_gemm, plan_gru, scheduled_gemm,
                                     scheduled_gru)

DTYPES = [torch.float32, torch.bfloat16]
SWEEP_SHAPE = (160, 224, 96)          # tests/test_kernels.py block sweep
DEEPBENCH_GRU = [(32, 512), (32, 1024), (16, 1536), (32, 1792)]


def pow2_ceil(x):
    return 1 << max(0, x - 1).bit_length()


def sweep_lowering(block):
    m, n, k = SWEEP_SHAPE
    blk = [min(b, e) for b, e in zip(block, SWEEP_SHAPE)]
    return {"kind": "pallas_gpu_gemm", "block": blk,
            "grid": [-(-e // b) for e, b in zip((m, n, k), blk)]}


def assert_launchable(cfg, lowering, m, n, dtype, k=None):
    route = ROUTES[cfg.route]
    assert route is gemm_route(dtype, k)
    built = (route.tile_m, route.tile_n, route.tile_k)
    for dim, blk, dims in zip(cfg.tile, lowering["block"], built):
        assert dim in dims and dim & (dim - 1) == 0, cfg
        assert dim <= max(dims[0], pow2_ceil(blk)), cfg
    assert cfg.block == tuple(lowering["block"])
    assert cfg.smem_bytes == route.smem_bytes(cfg.tile, dtype)
    assert cfg.smem_bytes <= MAX_SMEM_BYTES
    assert cfg.threads == route.threads(cfg.tile)
    assert cfg.grid[0] * cfg.tile[0] >= m and cfg.grid[1] * cfg.tile[1] >= n
    assert cfg.split >= 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k", DEEPBENCH_GEMM_SIZES)
def test_launch_config_deepbench(m, n, k, dtype):
    low = compile_gemm(m, n, k, graph=gpu_sm(8)).lowering
    # the cluster-sized block the bridge exists for: several times one
    # block's shared memory, and not a power of two
    assert low["smem_bytes"] > MAX_SMEM_BYTES
    cfg = launch_config(low, dtype, (m, n, k))
    assert_launchable(cfg, low, m, n, dtype, k)
    assert cfg.split == split_k(m, n, k, cfg.tile)
    assert plan_gemm(m, n, k, dtype=dtype)[0] == cfg


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [(32, 32, 32), (64, 128, 32),
                                   (128, 64, 256)])
def test_launch_config_block_sweep(block, dtype):
    low = sweep_lowering(block)
    assert_launchable(launch_config(low, dtype), low, *SWEEP_SHAPE[:2], dtype)


def test_launch_config_rejects_other_lowerings():
    with pytest.raises(CompileError):
        launch_config({"kind": "stream"}, torch.float32)


@pytest.mark.parametrize("batch,hidden", DEEPBENCH_GRU)
def test_gru_tile_deepbench(batch, hidden):
    (bb, bh), cost = plan_gru(batch, hidden)
    tb, th = gru_tile((bb, bh))
    assert cost > 0 and tb in TILE_B and th in TILE_H
    assert tb >= min(batch, TILE_B[-1])      # the batch stays in one block
    assert th <= max(16, pow2_ceil(bh))


# --------------------------------------------------------------------------- #
# Devices
# --------------------------------------------------------------------------- #


def gru_numpy_params(E=6, H=8):
    rng = np.random.default_rng(0)
    return {n: rng.uniform(-1, 1, size=(E, H) if n[0] == "W" else
                           (H, H) if n[0] == "U" else (H,))
            for n in PARAM_NAMES}


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedGRU.from_numpy(gru_numpy_params())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedGRU(6, 8)
    assert cuda.resolve_device("cpu") == torch.device("cpu")


def test_cpu_path_launches_nothing():
    before = telemetry.counters()
    a, b = torch.rand(40, 24), torch.rand(24, 56)
    torch.testing.assert_close(scheduled_gemm(a, b)[0], a @ b)
    bias = torch.rand(56)
    torch.testing.assert_close(gemm_bias_act(a, b, bias, "sigmoid"),
                               torch.sigmoid(a @ b + bias))
    model = FusedGRU.from_numpy(gru_numpy_params(), device="cpu")
    assert all(model.params()[n].device.type == "cpu" for n in PARAM_NAMES)
    xs, h0 = torch.rand(3, 2, 6), torch.rand(2, 8)
    out = model(xs, h0)
    torch.testing.assert_close(out, scheduled_gru(xs, h0, model))
    torch.testing.assert_close(gru_cell(xs[0], h0, model.params()),
                               gru_seq(xs[:1], h0, model.params()))
    after = telemetry.counters()
    assert {n: after[n] - before[n] for n in telemetry.LAUNCH_COUNTERS} \
        == dict.fromkeys(telemetry.LAUNCH_COUNTERS, 0)


def test_wrappers_reject_what_no_kernel_takes():
    a = torch.rand(8, 4)
    with pytest.raises(ValueError, match="tile"):
        gemm(a, torch.rand(4, 8), tile=(48, 16, 16))
    with pytest.raises(ValueError, match="shapes"):
        gemm(a, torch.rand(5, 8))
    with pytest.raises(TypeError):
        gemm(a, torch.rand(4, 8, dtype=torch.float64))
    b, bias = torch.rand(4, 8), torch.rand(8)
    with pytest.raises(ValueError, match="activation"):
        gemm_bias_act(a, b, bias, fn="gelu")
    with pytest.raises(ValueError, match="bias"):
        gemm_bias_act(a, b, torch.rand(7))
    with pytest.raises(ValueError, match="bias"):
        gemm_bias_act(a, b, bias.double())
    with pytest.raises(ValueError, match="tile"):
        gemm_bias_act(a, b, bias, tile=(16, 16, 64))
    p = FusedGRU(6, 8, device="cpu").params()
    with pytest.raises(ValueError, match="tile"):
        gru_cell(torch.rand(2, 6), torch.rand(2, 8), p, tile=(8, 16))
    with pytest.raises(ValueError, match="Wr"):
        gru_cell(torch.rand(2, 7), torch.rand(2, 8), p)
    with pytest.raises(ValueError, match="shape"):
        FusedGRU.from_numpy({**gru_numpy_params(), "bz": np.zeros(3)},
                            device="cpu")
