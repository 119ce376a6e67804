"""On the card only (marker ``gpu``): every CUDA kernel of the port against
its plain PyTorch version, the measured tuner's evaluator, the slice end
to end, serving and the train step against the CPU.  Imports nothing of
JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.core.sysgraph import gpu_sm
from repro_torch.kernels import ref
from repro_torch.kernels.gemm import (ACTS, block_tile, device_sms, gemm,
                                      gemm_bias_act, gemm_launch, gemm_route,
                                      operand_route, projection)
from repro_torch.kernels.gru import (PARAM_NAMES, TILE_B, TILE_H, FusedGRU,
                                     _recurrence, device_smem, device_split,
                                     gru_cell, gru_seq, gru_seq_launch,
                                     pack_w, seq_route, step_blocks_per_sm,
                                     step_route)
from repro_torch.kernels.ops import (scheduled_conv, scheduled_gemm,
                                     scheduled_gru)
from repro_torch.models import resnet50_1x1_reference as resnet
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


def launched(name: str) -> int:
    """A launch counter as it reads now (``telemetry.counters()``); a test
    takes the difference of two reads."""
    return telemetry.counters()[name]


def counts():
    return tuple(map(launched, ("gemm.launches", "gemm_bias_act.launches",
                                "gemm_transpose", "gemm_reduce")))


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


def gru_operands(rng, T, B, E, H, device):
    p = {n: to_torch(v * np.float32(H ** -0.5), device=device)
         for n, v in make_gru_params(rng, E, H).items()}
    return (p, to_torch(rand(rng, (T, B, E)), device=device),
            to_torch(rand(rng, (B, H)), device=device))


def gru_counts():
    return tuple(map(launched, ("gru_cell.launches", "gru_cell_reduce",
                                "gru_seq.launches",
                                "gemm_bias_act.launches")))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(16, 16), (16, 32), (16, 64), (32, 16),
                                  (32, 32), (32, 64)])
def test_gru_kernels_on_card(cuda_device, tile):
    """K3 at every built tile, and K4: one K2 projection and one
    persistent launch a sequence, no K3."""
    rng = np.random.default_rng(4)
    T, B, E, H = 6, 20, 72, 200
    p, xs, h0 = gru_operands(rng, T, B, E, H, cuda_device)
    split = device_split(B, E, H, tile, cuda_device, step_route(E, H))
    before = gru_counts()
    np.testing.assert_allclose(as_f32(gru_cell(xs[0], h0, p, tile=tile)),
                               as_f32(ref.gru_cell_ref(xs[0], h0, p)),
                               **F32_TOL)
    after_cell = gru_counts()
    assert after_cell == (before[0] + 1, before[1] + (split > 1), before[2],
                          before[3])
    mma = launched("gru_seq.mma")
    np.testing.assert_allclose(as_f32(gru_seq(xs, h0, p)),
                               as_f32(ref.gru_seq_ref(xs, h0, p)),
                               rtol=1e-4, atol=1e-5)
    assert gru_counts() == (after_cell[0], after_cell[1], after_cell[2] + 1,
                            after_cell[3] + 1)
    assert launched("gru_seq.mma") == mma      # f32 keeps the fmaf loop


@pytest.mark.gpu
@pytest.mark.parametrize("B,E,H,tile,split_on", [
    (32, 1792, 1792, (16, 16), False), (32, 1792, 1792, (32, 32), True),
    (4, 64, 512, (16, 16), True), (3, 12, 50, (16, 32), True),
    (1, 5, 7, (32, 16), True), (17, 40, 33, (32, 64), True),
    (64, 64, 4096, (16, 16), False)])
def test_gru_cell_split_on_and_off_on_card(cuda_device, B, E, H, tile,
                                           split_on):
    """K3 against gru_cell_ref and against the split plain version, with
    the split on and off (one slice where the tiles already fill whole
    waves), on both copy routes (H % 4 != 0 takes 4-byte copies)."""
    rng = np.random.default_rng(B + E + H)
    p, xs, h = gru_operands(rng, 1, B, E, H, cuda_device)
    split = device_split(B, E, H, tile, cuda_device, step_route(E, H))
    assert (split > 1) == split_on
    before = launched("gru_cell_reduce")
    got = gru_cell(xs[0], h, p, tile=tile)
    torch.cuda.synchronize()
    assert launched("gru_cell_reduce") == before + split_on
    np.testing.assert_allclose(as_f32(got),
                               as_f32(ref.gru_cell_ref(xs[0], h, p)),
                               **F32_TOL)
    np.testing.assert_allclose(
        as_f32(got), as_f32(ref.gru_cell_split_ref(xs[0], h, p, 32, split)),
        **F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,E,H", [(5, 3, 12, 50), (4, 17, 40, 33),
                                     (1, 1, 5, 7), (3, 64, 24, 200),
                                     (9, 32, 64, 1792), (3, 4, 16, 2048),
                                     (4, 65, 24, 200), (3, 130, 40, 1792),
                                     (2, 20, 8, 9000)])
def test_gru_seq_ragged_and_partly_resident_on_card(cuda_device, T, B, E, H):
    """K4 against gru_seq_ref at ragged sizes, at H >= 1792, where only
    part of each block's U panel fits in shared memory (none of it at
    H = 9000), and at batches above 64 rows or H wide enough to cut the
    launch's rows, which run as groups of rows, one launch each."""
    rng = np.random.default_rng(T + B + E + H)
    p, xs, h0 = gru_operands(rng, T, B, E, H, cuda_device)
    launch = gru_seq_launch(B, E, H, device_sms(cuda_device),
                            device_smem(cuda_device))
    if H >= 1792:
        assert launch.rows_on_chip < H
        assert (launch.rows_on_chip > 0) == (H <= 2048)
    seqs = launched("gru_seq.launches")
    projections = launched("gemm_bias_act.launches")
    got = gru_seq(xs, h0, p)
    assert launched("gru_seq.launches") - seqs == -(-B // launch.batch)
    assert launched("gemm_bias_act.launches") - projections == 1
    np.testing.assert_allclose(as_f32(got),
                               as_f32(ref.gru_seq_ref(xs, h0, p)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_gru_kernels_bit_identical_across_runs(cuda_device):
    """Fixed summation orders (k-lanes, slices, steps): two runs of K3 (split
    on) and of K4 (U partly resident) give the same bits."""
    rng = np.random.default_rng(12)
    T, B, E, H = 16, 32, 1792, 1792
    p, xs, h0 = gru_operands(rng, T, B, E, H, cuda_device)
    assert device_split(B, E, H, (32, 16), cuda_device) > 1
    cells = [as_f32(gru_cell(xs[0], h0, p, tile=(32, 16))) for _ in range(2)]
    seqs = [as_f32(gru_seq(xs, h0, p)) for _ in range(2)]
    np.testing.assert_array_equal(cells[0], cells[1])
    np.testing.assert_array_equal(seqs[0], seqs[1])


@pytest.mark.gpu
def test_gru_seq_grid_not_co_resident_raises(cuda_device):
    """A grid larger than the card can hold at once is refused before it
    launches (it would wait forever at the first barrier), and the card
    still works afterwards."""
    rng = np.random.default_rng(13)
    T, B, E, H = 3, 4, 16, 1792
    p, xs, h0 = gru_operands(rng, T, B, E, H, cuda_device)
    big = gru_seq_launch(B, E, H, sms=H)       # one column a block: 1792
    assert big.blocks == H
    w, bias = pack_w(p)
    g = xs.view(T * B, E) @ w + bias
    seqs = launched("gru_seq.launches")
    with pytest.raises(RuntimeError, match="co-resident"):
        _recurrence(g, h0, p, big)
    assert launched("gru_seq.launches") == seqs
    np.testing.assert_allclose(as_f32(gru_seq(xs, h0, p)),
                               as_f32(ref.gru_seq_ref(xs, h0, p)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_gru_seq_refuses_a_launch_its_layout_does_not_fit(cuda_device):
    """The C entry rebuilds the kernel's shared-memory layout from its own
    constants and refuses a launch that gives it less (it would write past
    its dynamic shared memory), before launching."""
    rng = np.random.default_rng(14)
    T, B, E, H = 3, 32, 16, 1792
    p, xs, h0 = gru_operands(rng, T, B, E, H, cuda_device)
    launch = gru_seq_launch(B, E, H, device_sms(cuda_device),
                            device_smem(cuda_device))
    w, bias = pack_w(p)
    g = xs.view(T * B, E) @ w + bias
    seqs = launched("gru_seq.launches")
    for short in (dataclasses.replace(launch, smem_bytes=launch.smem_bytes - 4),
                  dataclasses.replace(launch, rows_on_chip=launch.hp)):
        with pytest.raises(ValueError, match="no kernel"):
            _recurrence(g, h0, p, short)
    assert launched("gru_seq.launches") == seqs
    np.testing.assert_allclose(as_f32(_recurrence(g, h0, p, launch)),
                               as_f32(ref.gru_seq_ref(xs, h0, p)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_gru_library_constants_and_occupancy(cuda_device):
    """Binding the library checks its constants against the wrapper's
    copies; the step kernel's resident blocks a SM come from the card and
    enter the split."""
    for bb in TILE_B:
        for bh in TILE_H:
            for route in ("vec4", "scalar"):
                per_sm = step_blocks_per_sm((bb, bh), route, cuda_device)
                assert 1 <= per_sm <= 8
    with pytest.raises(ValueError):
        step_blocks_per_sm((8, 8), "vec4", cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_projection_stores_f32_sums_on_card(cuda_device, tdt):
    """K4's projection: K2's launch with an f32 store of the unrounded sums,
    whatever the operands' dtype.  Integer inputs make every sum exact, so
    it equals the plain version bit for bit on both routes, split or not;
    the store is f32, not the operands' type."""
    rng = np.random.default_rng(15)
    routes = set()
    for m, n, k in [(130, 70, 256), (64, 24, 64), (4096, 96, 248)]:
        a = to_torch(rng.integers(-4, 5, (m, k)).astype(np.float32), tdt,
                     cuda_device)
        b = to_torch(rng.integers(-4, 5, (k, n)).astype(np.float32), tdt,
                     cuda_device)
        bias = to_torch(rng.integers(-4, 5, (n,)).astype(np.float32) + 0.25,
                        tdt, cuda_device)
        a_odd = torch.empty(m * k + 1, dtype=tdt,
                            device=cuda_device)[1:].view(m, k)
        a_odd.copy_(a)
        for x in (a, a_odd):
            route = operand_route(x, b)
            routes.add(route.name)
            want = ref.gemm_bias_act_ref(x, b, bias, "", torch.float32)
            for tile in ROUTE_TILES[route.name]:
                _, (t, r) = expected_launch(x, b, tile)
                before = counts()
                got = projection(x, b, bias, tile=tile)
                torch.cuda.synchronize()
                assert counts() == (before[0], before[1] + 1, before[2] + t,
                                    before[3] + r)
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(
                    as_f32(got), as_f32(want),
                    err_msg=f"{route.name} {(m, n, k)} {tile}")
    assert routes == ({"simt", "wgmma"} if tdt == torch.bfloat16
                      else {"simt"})


def bf16_operands(rng, T, B, E, H, device):
    p, xs, h0 = gru_operands(rng, T, B, E, H, device)
    return ({n: v.to(torch.bfloat16) for n, v in p.items()},
            xs.to(torch.bfloat16), h0.to(torch.bfloat16))


BF16_TOL = TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,E,H,tile", [
    (6, 20, 72, 200, (32, 64)), (5, 3, 12, 50, (16, 16)),
    (4, 17, 40, 33, (32, 32)), (9, 32, 512, 512, (32, 64)),
    (3, 16, 1536, 1536, (16, 64)), (3, 32, 1792, 1792, (32, 16)),
    (4, 5, 20, 36, (16, 32)), (3, 8, 64, 3072, (16, 64)),
    (3, 65, 24, 200, (16, 32))])
def test_gru_bf16_kernels_on_card(cuda_device, T, B, E, H, tile):
    """bf16 K3 and K4 against their plain versions at JAX's bf16 tolerance
    (2e-2), on both copy routes of each (H % 4 != 0; H % 8 != 0), with U
    resident (all of it up to H = 1792 in bf16), partly resident (3072) and
    in groups of rows (65); the same bits from two runs; a sequence
    launches K2's projection and the persistent kernel, no K3, and every
    launch of it runs the tensor-core inner product."""
    rng = np.random.default_rng(T + B + E + H)
    p, xs, h0 = bf16_operands(rng, T, B, E, H, cuda_device)
    assert seq_route(B, E, H, torch.bfloat16, device_sms(cuda_device),
                     device_smem(cuda_device)) == "persistent"
    launch = gru_seq_launch(B, E, H, device_sms(cuda_device),
                            device_smem(cuda_device), torch.bfloat16)
    assert (launch.rows_on_chip < H) == (H == 3072)
    route = step_route(E, H)
    split = device_split(B, E, H, tile, cuda_device, route, torch.bfloat16)
    before = gru_counts()
    cells = [gru_cell(xs[0], h0, p, tile=tile) for _ in range(2)]
    torch.cuda.synchronize()
    assert gru_counts() == (before[0] + 2, before[1] + 2 * (split > 1),
                            before[2], before[3])
    assert cells[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(as_f32(cells[0]), as_f32(cells[1]))
    np.testing.assert_allclose(as_f32(cells[0]),
                               as_f32(ref.gru_cell_ref(xs[0], h0, p)),
                               **BF16_TOL)
    np.testing.assert_allclose(
        as_f32(cells[0]),
        as_f32(ref.gru_cell_split_ref(xs[0], h0, p, 32, split)), **BF16_TOL)
    before = gru_counts()
    mma = launched("gru_seq.mma")
    seqs = [gru_seq(xs, h0, p) for _ in range(2)]
    torch.cuda.synchronize()
    groups = -(-B // launch.batch)
    assert gru_counts() == (before[0], before[1], before[2] + 2 * groups,
                            before[3] + 2)
    assert launched("gru_seq.mma") == mma + 2 * groups
    assert seqs[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(as_f32(seqs[0]), as_f32(seqs[1]))
    np.testing.assert_allclose(as_f32(seqs[0]),
                               as_f32(ref.gru_seq_ref(xs, h0, p)),
                               **BF16_TOL)
    np.testing.assert_allclose(as_f32(seqs[0]),
                               as_f32(ref.gru_seq_hoisted_ref(xs, h0, p)),
                               **BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H", [(32, 512), (32, 1024), (16, 1536),
                                 (32, 1792)])
def test_gru_seq_bf16_at_deepbench_sizes_on_card(cuda_device, B, H):
    """K4 in bf16 at the four DeepBench sizes, T = 128, input = hidden: one
    tensor-core launch, against the plain version at JAX's bf16 tolerance,
    the same bits from two runs."""
    rng = np.random.default_rng(B + H)
    T = 128
    p, xs, h0 = bf16_operands(rng, T, B, H, H, cuda_device)
    launch = gru_seq_launch(B, H, H, device_sms(cuda_device),
                            device_smem(cuda_device), torch.bfloat16)
    assert launch.rows_on_chip == launch.hp == H and launch.lanes == 1
    before = gru_counts()
    mma = launched("gru_seq.mma")
    seqs = [gru_seq(xs, h0, p) for _ in range(2)]
    torch.cuda.synchronize()
    assert gru_counts() == (before[0], before[1], before[2] + 2,
                            before[3] + 2)
    assert launched("gru_seq.mma") == mma + 2
    np.testing.assert_array_equal(as_f32(seqs[0]), as_f32(seqs[1]))
    np.testing.assert_allclose(as_f32(seqs[0]),
                               as_f32(ref.gru_seq_ref(xs, h0, p)),
                               **BF16_TOL)


@pytest.mark.gpu
def test_gru_seq_bf16_unaligned_h0_on_card(cuda_device):
    """A bf16 h0 whose rows are not 16-byte aligned takes the 2-byte copy
    route (the kernel's VEC = false instantiation, tensor cores all the
    same); both routes match the plain version."""
    rng = np.random.default_rng(17)
    T, B, E, H = 5, 32, 64, 1024
    p, xs, h0 = bf16_operands(rng, T, B, E, H, cuda_device)
    odd = torch.empty(B * H + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(B, H)
    odd.copy_(h0)
    want = as_f32(ref.gru_seq_ref(xs, h0, p))
    mma = launched("gru_seq.mma")
    for h in (h0, odd):
        np.testing.assert_allclose(as_f32(gru_seq(xs, h, p)), want,
                                   **BF16_TOL)
    assert launched("gru_seq.mma") == mma + 2


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,sms", [
    (32, 128, 3),       # 43 columns a block: 3 m64 tiles, 3 warpgroups
    (32, 300, 4),       # 75: 4 tiles, 4 warpgroups, one tile each
    (32, 256, 3),       # 86: 5 tiles, two on the first warpgroup
    (32, 170, 1),       # 170: 8 tiles, two a warpgroup; rows in groups of 16
    (65, 1024, 12),     # 86 a block, U partly resident, groups of 64 rows
    (8, 12288, None)])  # every SM: 94 a block, 5 tiles, U partly resident
def test_gru_seq_bf16_loop_warpgroups_on_card(cuda_device, B, H, sms):
    """bf16 K4 with more than one warpgroup in the chunk loop, and with two
    m64 tiles a warpgroup (each warpgroup's A fragments of both held live
    until the wait): the partition on a card of ``sms`` SMs, launched
    through the C entry, against the plain version at JAX's bf16
    tolerance, the same bits from two runs."""
    rng = np.random.default_rng(B + H)
    T, E = 8, 16
    p, xs, h0 = bf16_operands(rng, T, B, E, H, cuda_device)
    launch = gru_seq_launch(B, E, H, sms or device_sms(cuda_device),
                            device_smem(cuda_device), torch.bfloat16)
    assert -(-3 * launch.cols // 64) > 2 and launch.lanes == 1
    w, bias = pack_w(p)
    g = projection(xs.view(T * B, E), w, bias)
    mma = launched("gru_seq.mma")
    seqs = [_recurrence(g, h0, p, launch) for _ in range(2)]
    torch.cuda.synchronize()
    assert launched("gru_seq.mma") == mma + 2 * -(-B // launch.batch)
    np.testing.assert_array_equal(as_f32(seqs[0]), as_f32(seqs[1]))
    np.testing.assert_allclose(as_f32(seqs[0]),
                               as_f32(ref.gru_seq_ref(xs, h0, p)),
                               **BF16_TOL)


@pytest.mark.gpu
def test_gru_seq_bf16_refuses_a_launch_short_of_shared_memory(cuda_device):
    """The C entry holds a bf16 launch to its layout's shared memory and
    refuses one short of it before launching."""
    rng = np.random.default_rng(16)
    T, B, E, H = 3, 32, 16, 1792
    p, xs, h0 = bf16_operands(rng, T, B, E, H, cuda_device)
    launch = gru_seq_launch(B, E, H, device_sms(cuda_device),
                            device_smem(cuda_device), torch.bfloat16)
    w, bias = pack_w(p)
    g = projection(xs.view(T * B, E), w, bias)
    seqs = launched("gru_seq.launches")
    bad = dataclasses.replace(launch, smem_bytes=launch.smem_bytes - 4)
    with pytest.raises(ValueError, match="no kernel"):
        _recurrence(g, h0, p, bad)
    assert launched("gru_seq.launches") == seqs
    np.testing.assert_allclose(as_f32(_recurrence(g, h0, p, launch)),
                               as_f32(ref.gru_seq_ref(xs, h0, p)),
                               **BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [9505, 12288])
def test_gru_seq_step_route_above_the_persistent_limit(cuda_device, H):
    """Where no block of the persistent kernel holds its share of a step
    (f32, B = 8, H > 9504 on an H100), the sequence runs as T launches of
    K3, within the GRU-sequence tolerance of its plain version."""
    rng = np.random.default_rng(H)
    T, B, E = 3, 8, 512
    p, xs, h0 = gru_operands(rng, T, B, E, H, cuda_device)
    sms, smem = device_sms(cuda_device), device_smem(cuda_device)
    assert seq_route(B, E, H, torch.float32, sms, smem) == "step"
    with pytest.raises(ValueError, match="shared memory"):
        gru_seq_launch(B, E, H, sms, smem)
    before = gru_counts()
    got = gru_seq(xs, h0, p)
    torch.cuda.synchronize()
    after = gru_counts()
    assert (after[0] - before[0], after[2] - before[2],
            after[3] - before[3]) == (T, 0, 0)
    np.testing.assert_allclose(as_f32(got),
                               as_f32(ref.gru_seq_ref(xs, h0, p)),
                               rtol=1e-4, atol=1e-5)


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


#: DeepBench GEMMs of the clock test: a wide one, one with split-K and
#: the 35-row one
CLOCK_SHAPES = [(1760, 128, 1760), (2560, 64, 2560), (35, 700, 2048)]
K1_KERNELS = ("transpose_kernel", "simt_kernel", "wgmma_kernel",
              "reduce_kernel")
#: the most a call's first K1 kernel may start after its ``k1.call`` span
#: starts, in us.  On an H100 80GB HBM3 (700 W) over 150 calls a dtype the
#: C entry took a median 36 us (f32) and 20 us (bf16) from the span's start
#: to the kernel's, 71 and 87 us at the 99th percentile and at most 104 and
#: 135 us.  200 us leaves room for a busy host; that every kernel lies
#: between its call's span and the next call's holds the two clocks
#: together to within one waited-for call
LAUNCH_LIMIT_US = 200.0


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_span_clock_is_the_device_traces_on_card(cuda_device, tdt):
    """The recorder's spans and the profiler's trace share a clock: every
    K1 launch the trace records on the host lies inside its ``k1.call``
    span; the trace's device times are its host times shifted by one
    offset (``device_offset_bounds_ns`` finds lo <= hi); and shifted, each
    call's K1 kernels start at or after its span starts and end before the
    next call's starts (each call is waited for), the first within
    ``LAUNCH_LIMIT_US`` in 99% of calls after the first round, whose first
    launch pays the profiler's set-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(11)
    operands = [(to_torch(rand(rng, (m, k)), tdt, cuda_device),
                 to_torch(rand(rng, (k, n)), tdt, cuda_device))
                for m, n, k in CLOCK_SHAPES]
    for a, b in operands:                          # the memo, the library
        scheduled_gemm(a, b)
    torch.cuda.synchronize()
    with telemetry.recording() as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(51):
                for a, b in operands:
                    scheduled_gemm(a, b)
                    torch.cuda.synchronize()
    results = prof.profiler.kineto_results
    start = results.trace_start_ns()
    events = results.events()
    lo, hi = telemetry.device_offset_bounds_ns(events)
    assert lo <= hi, (lo, hi)
    shift = (lo + hi) / 2

    def us(t_ns):
        return (t_ns - start) / 1e3
    calls = [(telemetry.to_profiler_us(s.start_ns, start),
              telemetry.to_profiler_us(s.end_ns, start))
             for s in rec.spans() if s.name == "k1.call"]
    assert rec.dropped == 0 and len(calls) == 153
    host = {e.correlation_id(): e for e in events
            if e.device_type() == DeviceType.CPU and e.correlation_id()}
    firsts = {}
    for k in events:
        if k.device_type() != DeviceType.CUDA \
                or not any(n in k.name() for n in K1_KERNELS):
            continue
        launch = host.get(k.correlation_id())
        if launch is None:                     # a record the profiler lost
            continue
        opened = [i for i, (s, _) in enumerate(calls)
                  if s <= us(launch.start_ns())]
        assert opened, us(launch.start_ns())
        j = opened[-1]
        assert us(launch.end_ns()) <= calls[j][1], (j, calls[j])
        nxt = calls[j + 1][0] if j + 1 < len(calls) else float("inf")
        ks, ke = us(k.start_ns() - shift), us(k.end_ns() - shift)
        assert calls[j][0] <= ks and ke <= nxt, (j, calls[j], ks, ke, nxt)
        firsts[j] = min(firsts.get(j, ks), ks)
    assert len(firsts) >= 0.99 * len(calls)
    delays = [firsts[j] - calls[j][0] for j in firsts if j >= len(operands)]
    late = [d for d in delays if d > LAUNCH_LIMIT_US]
    assert len(late) <= 0.01 * len(delays), sorted(delays)[-5:]


@pytest.mark.gpu
def test_span_tree_of_each_path_on_card(cuda_device):
    """On the card every entry records the spans of its launch path, and
    the counters read the launches it made."""
    rng = np.random.default_rng(12)
    bf = torch.bfloat16
    a = to_torch(rand(rng, (256, 512)), bf, cuda_device)
    b = to_torch(rand(rng, (512, 128)), bf, cuda_device)
    p = make_gru_params(rng, 64, 64)
    model = FusedGRU.from_numpy(p, device=cuda_device, dtype=bf)
    xs = to_torch(rand(rng, (4, 8, 64)), bf, cuda_device)
    h0 = to_torch(rand(rng, (8, 64)), bf, cuda_device)
    scheduled_gemm(a, b)
    scheduled_gru(xs, h0, model)
    torch.cuda.synchronize()
    before = telemetry.counters()
    with telemetry.recording() as rec:
        scheduled_gemm(a, b)
        scheduled_gru(xs, h0, model)
        gru_cell(xs[0], h0, model.params())
    torch.cuda.synchronize()
    after = telemetry.counters()
    spans = rec.spans()
    below = {}
    for s in spans:
        key = spans[s.parent].name if s.parent >= 0 else None
        below.setdefault(key, []).append(s.name)
    assert below[None] == ["ops.gemm", "ops.gru", "k3"]
    assert below["ops.gemm"] == ["ops.plan", "k1"]
    assert below["ops.gru"] == ["ops.plan", "ops.plan", "k4"]
    assert below["k1"] == ["k1.check", "k1.alloc", "k1.call"]
    assert below["k4"] == ["k4.pack_w", "k2", "k4.pack_u", "k4.alloc",
                           "k4.call"]
    assert below["k2"] == ["k2.check", "k2.alloc", "k2.call"]
    assert below["k3"] == ["k3.check", "k3.alloc", "k3.call"]
    assert [s.request for s in spans if s.parent < 0] == [0, 1, 2]
    got = {k: after[k] - before[k] for k in after}
    assert got["compile.memo_hit"] == 3 and got["compile.fresh"] == 0
    assert got["gemm.launches"] == got["gemm_bias_act.launches"] == 1
    assert got["gru_seq.launches"] == got["gru_cell.launches"] == 1
    assert got["gru_seq.mma"] == 1                  # a bf16 sequence


#: the 12 distinct (h, w, cin, cout) of ResNet-50's 33 stride-1 1x1 convs
RESNET_1X1 = list(dict.fromkeys((c["h"], c["w"], c["cin"], c["cout"])
                                for c in resnet.pointwise_convs()))


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_resnet_1x1_convs_on_card(cuda_device, tdt, monkeypatch):
    """ResNet-50's stride-1 pointwise convs at batch 28 and published widths
    through ``scheduled_conv``: each one K1 launch on views of x and w,
    returning K1's own output, within K1's card tolerances of the float64
    reference (f32: scaled by max |y|)."""
    from repro_torch.kernels import ops
    sound, seen = ops.gemm, []

    def spy(a, b, tile=None):
        seen.append((a, b, sound(a, b, tile=tile)))
        return seen[-1][2]
    monkeypatch.setattr(ops, "gemm", spy)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(34)
    tol = TOL[tdt]
    for h, w, cin, cout in RESNET_1X1:
        x = torch.randn((28, h, w, cin), generator=gen,
                        device=cuda_device).to(tdt)
        wt = resnet.init_weight(cin, cout, gen, cuda_device).to(tdt)
        before = counts(), launched("conv.gemm")
        y, cfg = scheduled_conv(x, wt)
        torch.cuda.synchronize()
        assert counts()[0] == before[0][0] + 1
        assert launched("conv.gemm") == before[1] + 1
        a, b, c = seen[-1]
        assert a.data_ptr() == x.data_ptr() and b.data_ptr() == wt.data_ptr()
        assert y.data_ptr() == c.data_ptr() and y.shape == (28, h, w, cout)
        assert cfg.route == ("wgmma" if tdt == torch.bfloat16 else "simt")
        want = resnet.conv1x1(x, wt)
        scale = float(want.abs().max()) if tdt == torch.float32 else 1.0
        np.testing.assert_allclose(
            as_f32(y), want.float().cpu().numpy(), rtol=tol["rtol"],
            atol=tol["atol"] * scale, err_msg=f"{(h, w, cin, cout)} {cfg}")


@pytest.mark.gpu
def test_span_tree_of_scheduled_conv_on_card(cuda_device):
    """A warm bf16 conv records the plan's extraction and K1's launch path
    below ``ops.conv``, and counts one launch of each of K1's passes, one
    ``conv.gemm`` and one memo hit."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(35)
    x = torch.randn((4, 14, 14, 256), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    wt = resnet.init_weight(256, 64, gen, cuda_device).to(torch.bfloat16)
    scheduled_conv(x, wt)
    torch.cuda.synchronize()
    before = telemetry.counters()
    with telemetry.recording() as rec:
        _, cfg = scheduled_conv(x, wt)
    torch.cuda.synchronize()
    after = telemetry.counters()
    spans = rec.spans()
    below = {}
    for s in spans:
        key = spans[s.parent].name if s.parent >= 0 else None
        below.setdefault(key, []).append(s.name)
    assert below[None] == ["ops.conv"]
    assert below["ops.conv"] == ["ops.plan", "k1"]
    assert below["ops.plan"] == ["compile.conv", "plan.extract",
                                 "plan.launch"]
    assert below["k1"] == ["k1.check", "k1.alloc", "k1.call"]
    got = {k: after[k] - before[k] for k in after}
    assert got["compile.memo_hit"] == got["conv.gemm"] == 1
    assert got["compile.fresh"] == 0
    assert got["gemm.launches"] == got["gemm_transpose"] == 1
    assert got["gemm_reduce"] == int(cfg.split > 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_at_the_learned_models_block(cuda_device, tmp_path, monkeypatch,
                                       dtype):
    """K1 through ``gemm(a, b)`` with no tile on a shape the tuning cache
    has never seen (conv3_1x1b of ResNet-50 at minibatch 28, extracted as
    one GEMM): the tile comes from ``tuned_block``'s model branch."""
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels.gemm import (route_tile, tuned_block,
                                          tuned_record)
    from repro_torch.search.cache import TuningCache, set_default_cache
    from repro_torch.search.model import (ModelStore, fresh_labels,
                                          model_key, predict_gemm_block,
                                          set_default_store, train_family)
    from repro_torch.search.tune import _gemm_case
    m, n, k = 21952, 512, 128
    graph = gpu_sm(8)
    samples = fresh_labels(_gemm_case(256, 192, 130), graph, n=40, seed=0)
    model, _ = train_family(model_key("matmul", graph), "matmul", samples,
                            graph)
    store = ModelStore(str(tmp_path / "models.json"))
    store.store(model)
    seen = []
    check = gemm_mod._check_tile

    def spy(tile, route):
        seen.append(tuple(tile))
        return check(tile, route)
    monkeypatch.setattr(gemm_mod, "_check_tile", spy)
    set_default_cache(TuningCache(str(tmp_path / "tuning.json")))
    set_default_store(store)
    try:
        assert tuned_record(m, n, k) is None
        block = predict_gemm_block(m, n, k)
        assert block is not None and tuned_block(m, n, k) == block
        rng = np.random.default_rng(11)
        a = to_torch(rand(rng, (m, k)), dtype, cuda_device)
        b = to_torch(rand(rng, (k, n)), dtype, cuda_device)
        before = launched("gemm.launches")
        got = gemm(a, b)
        torch.cuda.synchronize()
    finally:
        set_default_store(None)
        set_default_cache(None)
    assert launched("gemm.launches") == before + 1
    assert seen == [route_tile(block, operand_route(a, b))]
    want = ref.gemm_ref(a, b)
    tol = dict(TOL[dtype])
    if dtype == torch.float32:
        tol["atol"] *= float(want.abs().max())
    np.testing.assert_allclose(as_f32(got), as_f32(want), **tol)


# --------------------------------------------------------------------------- #
# The graph tier on the card
# --------------------------------------------------------------------------- #

#: the GEMM nodes of whisper-medium's decoder block at T = 8 (D = 1024, 16
#: heads of 64, F = 4096): (m, n, k) and whether B is stored transposed
#: (``matmul_nt``: the scores q·kᵀ)
BLOCK_GEMMS = [(8, 64, 1024, False), (8, 8, 64, True), (8, 64, 8, False),
               (8, 1024, 64, False), (8, 4096, 1024, False),
               (8, 1024, 4096, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,nt", BLOCK_GEMMS)
def test_k1_at_the_block_plans_launch(cuda_device, m, n, k, nt):
    from repro_torch.compile import compile_program
    from repro_torch.core import instructions, kernels_ir
    from repro_torch.graph.trace import matmul_nt
    from repro_torch.kernels.ops import launch_config
    prog = matmul_nt(m, n, k) if nt else kernels_ir.matmul(m, n, k)
    art = compile_program(prog, gpu_sm(8), None, instructions.tpu_isa(),
                          allow_transforms=False, use_cache=False)
    assert art.lowering["kind"] == "pallas_gpu_gemm"
    tile = launch_config(art.lowering, torch.float32, (m, n, k)).tile
    rng = np.random.default_rng(m * n + k)
    a = to_torch(rand(rng, (m, k)), device=cuda_device)
    b = to_torch(rand(rng, (k, n)), device=cuda_device)
    before = launched("gemm.launches")
    got = gemm(a, b, tile=tile)
    torch.cuda.synchronize()
    assert launched("gemm.launches") == before + 1
    want = ref.gemm_ref(a, b)
    np.testing.assert_allclose(
        as_f32(got), as_f32(want), rtol=1e-5,
        atol=1e-5 * float(want.abs().max()))


def _gemm_nodes(cg) -> int:
    """The graph's GEMM nodes by the kind the tracer and the fusion pass
    gave them (``gemm``, or ``fused``: a GEMM with its epilogue), each of
    which the executor must run as one K1 or K2 launch: no such node may
    fall to the interpreter, and no other node may launch."""
    from repro_torch.graph.execute import node_steps
    steps = node_steps(cg)
    gemms = {n.name for n in cg.graph.nodes if n.kind in ("gemm", "fused")}
    assert {name for name, s in steps.items() if s is not None} == gemms
    return len(gemms)


def _trace_block(fused: bool):
    from repro_torch.configs import get_trace_config
    from repro_torch.graph import (block_inputs, compile_graph,
                                   fuse_epilogues, trace_block)
    cfg = get_trace_config("whisper-medium")
    g = trace_block(cfg, seq_len=8)
    inputs = block_inputs(g)
    decisions = []
    if fused:
        g, decisions = fuse_epilogues(g)
    return cfg, compile_graph(g, gpu_sm(8), use_cache=False,
                              decisions=decisions), inputs


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_trace_block_on_card_bit_exact(cuda_device, fused):
    from repro_torch.models.traceable import block_reference
    cfg, cg, inputs = _trace_block(fused)
    # a GEMM node (plain, or fused with its epilogue) is one K1 launch
    gemm_nodes = _gemm_nodes(cg)
    before = launched("gemm.launches")
    got = cg.execute(inputs, return_all=True)
    torch.cuda.synchronize()
    assert launched("gemm.launches") - before == gemm_nodes > 0
    plain = cg.execute(inputs, device="cpu", return_all=True)
    assert set(got) == set(plain)
    for t, v in plain.items():
        assert got[t].device.type == "cuda"
        assert torch.equal(got[t].cpu(), v), t
    want = block_reference(inputs, cfg, 8, device=cuda_device,
                           return_all=True)
    for t, v in want.items():
        if t in got:
            assert torch.equal(got[t], v), t


@pytest.mark.gpu
@pytest.mark.parametrize("argv", [[], ["--no-fuse"], ["--seq", "16"]],
                         ids=["fused", "unfused", "seq16"])
def test_graph_cli_validate_on_card(cuda_device, tmp_path, capsys, argv):
    """``python -m repro_torch.graph --validate`` with no ``--device``: the
    compiled block runs on the card, one K1 launch for each GEMM node
    (plain or fused with its epilogue), bit-exact against the interpreter
    and the float64 reference."""
    import json
    import repro_torch.graph.__main__ as graph_cli
    from repro_torch.configs import get_trace_config
    from repro_torch.graph import compile_graph, fuse_epilogues, trace_block
    seq = int(argv[1]) if argv[:1] == ["--seq"] else 8
    g = trace_block(get_trace_config("olmo-1b"), seq_len=seq)
    decisions = []
    if "--no-fuse" not in argv:
        g, decisions = fuse_epilogues(g)
    cg = compile_graph(g, decisions=decisions)
    gemm_nodes = _gemm_nodes(cg)
    path = tmp_path / "graph.json"
    before = launched("gemm.launches")
    assert graph_cli.main([*argv, "--validate", "--json", str(path)]) == 0
    torch.cuda.synchronize()
    assert launched("gemm.launches") - before == gemm_nodes > 0
    out = capsys.readouterr().out
    for check in ("executed-vs-interpreted", "interpreted-vs-reference",
                  "executed-vs-reference"):
        assert f"[ok] {check}: bit-exact=True" in out
    assert json.loads(path.read_text())["validated"] is True


def _whisper_stack(cfg, T, S, layers, device):
    """whisper's decoder stack traced, fused and compiled, its inputs from
    seed 0 on ``device``, and the float64 reference's outputs."""
    from repro_torch.graph import (compile_graph, fuse_epilogues,
                                   trace_whisper_decoder, whisper_inputs)
    from repro_torch.models import whisper_block_reference as R
    g, decisions = fuse_epilogues(trace_whisper_decoder(cfg, T, S, layers))
    cg = compile_graph(g, use_cache=False, decisions=decisions)
    gen = torch.Generator(device=device).manual_seed(0)
    params = R.init_params(cfg.d_model, cfg.d_ff, cfg.vocab_size, layers,
                           gen, device)
    x = torch.randn(T, cfg.d_model, generator=gen, device=device)
    xa = torch.randn(S, cfg.d_model, generator=gen, device=device)
    want = dict(zip(g.outputs, R.decoder(params, x, xa, cfg.n_heads,
                                         layers)))
    return cg, whisper_inputs(g, params, x, xa), want


def _rel_rms(got, want) -> float:
    return float((got.double() - want).norm() / want.norm())


@pytest.mark.gpu
def test_whisper_stack_on_card_matches_the_reference(cuda_device):
    """The small stack of the CPU tests on the card: within 1e-5 of the
    float64 reference (f32 node boundaries and K1's f32 sums), and of the
    same graph run on the CPU."""
    from repro_torch.configs import get_trace_config
    cg, inputs, want = _whisper_stack(get_trace_config("whisper-medium"), 8,
                                      12, 2, cuda_device)
    got = cg.execute(inputs)
    plain = cg.execute({t: v.cpu() for t, v in inputs.items()}, device="cpu")
    for t, v in want.items():
        assert got[t].device.type == "cuda"
        assert _rel_rms(got[t], v) < 1e-5, t
        assert _rel_rms(got[t].cpu(), plain[t].double()) < 1e-5, t


@pytest.mark.gpu
def test_whisper_layer_at_full_width_on_card(cuda_device):
    """One layer of whisper-medium at its published widths, 32 tokens over
    1500 frames and the 51,865-row head: every GEMM node is one K1 or K2
    launch, and the logits are within ``whisper-block-f32``'s limit on
    ``rel_rms`` (3e-5) of the float64 reference."""
    from repro_torch.configs import get_config
    cg, inputs, want = _whisper_stack(get_config("whisper-medium"), 32, 1500,
                                      1, cuda_device)
    # by hand: per attention, 16 heads of q, k, v, scores, weighted values
    # and output projection; fc1, fc2; the head.  Biased: q and v of every
    # head, head 0's output projection (bo), fc1, fc2
    assert _gemm_nodes(cg) == 2 * 16 * 6 + 2 + 1 == 195
    n_k2 = 2 * (16 * 2 + 1) + 2
    before = (launched("gemm.launches"), launched("gemm_bias_act.launches"))
    got = cg.execute(inputs)
    torch.cuda.synchronize()
    k1 = launched("gemm.launches") - before[0]
    k2 = launched("gemm_bias_act.launches") - before[1]
    assert (k1, k2) == (195 - n_k2, n_k2)
    assert _rel_rms(got["logits"], want["logits"]) < 3e-5
    assert _rel_rms(got["x1"], want["x1"]) < 3e-5


@pytest.mark.gpu
def test_interpret_program_bit_identical_across_runs(cuda_device):
    from repro_torch.core import kernels_ir
    from repro_torch.graph import fuse_epilogues, interpret_program
    from repro_torch.graph import trace_block
    from repro_torch.configs import get_config
    cfg = get_config("whisper-medium").scaled(n_layers=1, d_model=256,
                                              n_heads=4, d_ff=1024)
    fused, _ = fuse_epilogues(trace_block(cfg, seq_len=8))
    progs = [n.program for n in fused.nodes if n.kind == "fused"][:4]
    progs.append(kernels_ir.gru_cell(8, 96, 80))
    rng = np.random.default_rng(7)
    for prog in progs:
        ins = {b.name: to_torch(rand(rng, b.shape), device=cuda_device)
               for b in prog.buffers
               if not b.temp and b.name not in prog.outputs}
        one = interpret_program(prog, ins, cuda_device)
        two = interpret_program(prog, ins, cuda_device)
        for name, v in one.items():
            assert v.device.type == "cuda"
            assert torch.equal(v, two[name]), (prog.name, name)
        cpu = interpret_program(prog, {k: v.cpu() for k, v in ins.items()},
                                "cpu")
        for name, v in one.items():
            np.testing.assert_allclose(as_f32(v), as_f32(cpu[name]),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-7b", "whisper-medium", "xlstm-1.3b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_model_on_card_matches_the_cpu(cuda_device, arch, dtype):
    """A smoke-config model served on the card (``build_model``, its
    ``init`` on the card, ``launch.serve.generate``) against the same
    weights on the CPU: every step's logits within 1e-4 * max|cpu| in f32
    (cuBLAS sums in another order) and 2e-2 in bf16; greedy tokens equal in
    f32; and teacher forcing on the card within the smoke's SERVE_TOL."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate, make_batch
    from repro_torch.models import build_model
    cfg = get_smoke_config(arch).scaled(dtype=dtype)
    gen = torch.Generator(cuda_device).manual_seed(0)
    card = build_model(cfg).init(gen)
    assert card.device.type == "cuda"
    cpu = build_model(cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = make_batch(cfg, 3, 7, cuda_device, gen)
    rec_card, rec_cpu = {}, {}
    toks = generate(card, batch, 6, record=rec_card)
    cpu_toks = generate(cpu, {k: v.cpu() for k, v in batch.items()}, 6,
                        record=rec_cpu)
    assert toks.device.type == "cuda" and rec_card["prefill_ms"] > 0
    got, want = rec_card["logits"].float().cpu(), rec_cpu["logits"].float()
    rel = 1e-4 if dtype == "float32" else 2e-2
    assert float((got - want).abs().max()) <= rel * float(want.abs().max())
    if dtype == "float32":
        assert torch.equal(toks.cpu(), cpu_toks)
    with torch.no_grad():
        full = dict(batch, tokens=torch.cat([batch["tokens"], toks], 1))
        ref = card.logits(full)[:, 6:].float().cpu()
    tol = 1e-3 if dtype == "float32" else 5e-2
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.fixture
def no_tf32():
    """f32 products in f32 (cuBLAS), restored afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def assert_adamw_step_matches_the_cpu(model, opt_state, batch, opt_cfg):
    """One AdamW step (``apply_updates``) on the card's parameters and
    moments from the card's gradient of the loss on ``batch``, against the
    same step on the CPU from copies of those tensors: each parameter
    within 1e-6 * max|leaf| + 1e-5 * lr, each moment within 1e-5 *
    max|leaf| (the same elementwise f32 formula; the global norm sums in
    another order).  The train steps' parameters cannot be held so: the
    two devices' gradients differ in rounding, and Adam's update, near
    sign(g) * lr, moves an element whose gradient is 0 to within that
    rounding up to 2 lr apart."""
    from repro_torch.optim.adamw import OptState, apply_updates
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(
        model.loss(batch), list(params.values()), allow_unused=True,
        materialize_grads=True)))

    def host(tree):
        return {n: t.detach().cpu().clone() for n, t in tree.items()}

    cpu_p, cpu_mu, cpu_nu = host(params), host(opt_state.mu), \
        host(opt_state.nu)
    cpu_state = OptState(opt_state.step.cpu().clone(), cpu_mu, cpu_nu)
    apply_updates(params, grads, opt_state, opt_cfg)
    lr = float(apply_updates(cpu_p, host(grads), cpu_state, opt_cfg)[2]["lr"])
    assert lr > 0
    for got, want, lr_rel in ((params, cpu_p, 1e-5), (opt_state.mu, cpu_mu, 0),
                              (opt_state.nu, cpu_nu, 0)):
        for n, w in want.items():
            assert got[n].device.type == "cuda"
            bound = (1e-6 if lr_rel else 1e-5) * float(w.abs().max()) \
                + lr_rel * lr
            diff = float((got[n].detach().cpu() - w).abs().max())
            assert diff <= bound, (n, diff, bound)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x7b", "xlstm-1.3b",
                                  "jamba-1.5-large-398b", "whisper-medium"])
def test_train_step_on_card_matches_the_cpu(cuda_device, no_tf32, arch):
    """Two f32 smoke-config train steps (``make_train_step``: the loss's
    gradient and AdamW in place) on the card against the same weights and
    batches on the CPU, at the full lr from the first step: loss and
    grad_norm within rtol 1e-5 (the second step's after the first step's
    update); then a third AdamW step on the card's state held to the CPU's
    elementwise (``assert_adamw_step_matches_the_cpu``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import (DataConfig, add_frontend_stub,
                                           make_source)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    opt_cfg = AdamWConfig(warmup_steps=1)
    card, card_opt, card_step = make_train_step(cfg, opt_cfg,
                                                device=cuda_device)
    cpu, _, cpu_step = make_train_step(cfg, opt_cfg, device="cpu")
    cpu.init(torch.Generator().manual_seed(0))
    card.load_state_dict(cpu.state_dict())
    source = make_source(DataConfig(seed=1, global_batch=4, seq_len=16), cfg)
    for s in range(3):
        host = add_frontend_stub(source.batch(s), cfg, s)
        batch = {k: torch.as_tensor(v) for k, v in host.items()}
        on_card = {k: v.to(cuda_device) for k, v in batch.items()}
        if s == 2:
            assert_adamw_step_matches_the_cpu(card, card_opt, on_card,
                                              opt_cfg)
            break
        got = card_step(on_card)
        want = cpu_step(batch)
        np.testing.assert_allclose(float(want["lr"]), opt_cfg.lr,
                                   rtol=1e-6)
        for key in ("loss", "grad_norm"):
            assert got[key].device.type == "cuda"
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=f"{key} {s}")
    assert all(p.device.type == "cuda" for p in card.parameters())


@pytest.mark.gpu
def test_trainer_on_card_never_runs_on_the_cpu(cuda_device, tmp_path):
    """``build_trainer`` on the card: the batch the loss sees, every
    parameter, moment and the step counter, and the metrics are CUDA
    tensors; the driver's CLI on the card lowers the loss."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_trainer, main
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_smoke_config("olmo-1b")
    model, init_state, step, _ = build_trainer(
        cfg, AdamWConfig(warmup_steps=1), make_host_mesh(), device=None)
    carry = init_state(torch.Generator(cuda_device).manual_seed(0))
    seen = []
    loss = model.loss
    model.loss = lambda batch: seen.append(batch["tokens"].device) \
        or loss(batch)
    source = make_source(DataConfig(global_batch=4, seq_len=32), cfg)
    for s in range(2):
        carry, metrics = step(carry, source.batch(s))
    assert seen == [torch.device("cuda", 0)] * 2
    _, opt = carry
    tensors = [*model.parameters(), opt.step, *opt.mu.values(),
               *opt.nu.values(), *metrics.values()]
    assert all(t.device.type == "cuda" for t in tensors)
    assert int(opt.step) == 2
    losses = main(["--arch", "olmo-1b", "--smoke", "--steps", "12",
                   "--batch", "4", "--seq", "64", "--ckpt-dir",
                   str(tmp_path)])
    assert losses[-1] < losses[0]


@pytest.mark.gpu
def test_placed_trainer_on_a_one_rank_nccl_mesh_matches_the_unplaced(
        cuda_device, no_tf32, tmp_path):
    """``build_trainer`` on a one-rank NCCL process group and its (1, 1)
    ``DeviceMesh`` (DTensor parameters, moments and batches) against the
    unplaced trainer: olmo-1b at full width cut to 2 layers, f32, the same
    seed and batches, 2 steps; losses and grad norms within rtol 1e-6 (the
    same local ops on one rank), every parameter and moment equal within
    1e-6 * max|leaf|."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.dist.compat import make_mesh
    from repro_torch.dist.sharding import full
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_config("olmo-1b").scaled(n_layers=2, dtype="float32")
    opt_cfg = AdamWConfig(warmup_steps=1)
    source = make_source(DataConfig(seed=3, global_batch=2, seq_len=128),
                         cfg)

    def run(mesh):
        model, init_state, step, _ = build_trainer(cfg, opt_cfg, mesh,
                                                   device=cuda_device)
        carry = init_state(torch.Generator(cuda_device).manual_seed(0))
        metrics = [step(carry, source.batch(s))[1] for s in range(2)]
        return model, carry[1], metrics

    plain, plain_opt, want = run(make_mesh((1, 1), ("data", "model"),
                                           [cuda_device]))
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        placed, placed_opt, got = run(make_host_mesh())
        assert all(isinstance(p, DTensor) for p in placed.parameters())
        for g, w in zip(got, want):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(g[key]), float(w[key]),
                                           rtol=1e-6, err_msg=key)
        pairs = [(dict(plain.named_parameters()),
                  dict(placed.named_parameters())),
                 (plain_opt.mu, placed_opt.mu), (plain_opt.nu, placed_opt.nu)]
        for want_tree, got_tree in pairs:
            for n, w in want_tree.items():
                w = w.detach()
                diff = float((full(got_tree[n]).detach() - w).abs().max())
                assert diff <= 1e-6 * float(w.abs().max()), (n, diff)
    finally:
        dist.destroy_process_group()
