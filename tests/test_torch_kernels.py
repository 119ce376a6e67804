"""The port's kernels against the JAX package's: the CPU path of every
wrapper (K1, K2, K3, K4) against the Pallas kernels in interpret mode and
against ``repro.kernels.ref``, on the shapes and tolerances of
``tests/test_kernels.py``; and the slice end to end."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.gemm import gemm as jax_gemm
from repro.kernels.gemm import gemm_bias_act as jax_gemm_bias_act
from repro.kernels.gru import gru_cell as jax_gru_cell
from repro.kernels.gru import gru_seq as jax_gru_seq
from repro_torch.kernels import ref
from repro_torch.kernels.gemm import gemm, gemm_bias_act
from repro_torch.kernels.gru import (PARAM_NAMES, FusedGRU, gru_cell,
                                     gru_seq)
from repro_torch.kernels.ops import launch_config, plan_gru, scheduled_gemm

DTYPES = {"float32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-5)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16,
                       dict(rtol=2e-2, atol=2e-2))}
F32_TOL = DTYPES["float32"][2]


def rand(rng, shape):
    """One array of uniform(-1, 1) f32 for both packages."""
    return rng.uniform(-1, 1, size=shape).astype(np.float32)


def to_jax(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def to_torch(x, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def make_gru_params(rng, E, H):
    return {n: rand(rng, (E, H) if n[0] == "W" else
                    (H, H) if n[0] == "U" else (H,)) for n in PARAM_NAMES}


def gpu_lowering(block, m, n, k):
    """The ``pallas_gpu_gemm`` lowering ``LowerPass`` writes for a
    compute tile ``block`` over an (m, n, k) GEMM."""
    blk = [min(b, e) for b, e in zip(block, (m, n, k))]
    return {"kind": "pallas_gpu_gemm", "block": blk,
            "grid": [-(-e // b) for e, b in zip((m, n, k), blk)],
            "smem_bytes": 4 * (blk[0] * blk[2] + blk[2] * blk[1]
                               + blk[0] * blk[1])}


# --------------------------------------------------------------------------- #
# CPU path against the Pallas kernels (interpret mode) and the JAX oracles
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 128, 384),
                                   (64, 48, 96), (130, 70, 190),
                                   (1, 128, 512), (512, 1, 64)])
def test_gemm_matches_pallas(m, n, k, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(m * 7 + n * 3 + k)
    a, b = rand(rng, (m, k)), rand(rng, (k, n))
    got = as_f32(gemm(to_torch(a, tdt), to_torch(b, tdt)))
    ja, jb = to_jax(a, jdt), to_jax(b, jdt)
    np.testing.assert_allclose(got, as_f32(jax_gemm(ja, jb, interpret=True)),
                               **tol)
    np.testing.assert_allclose(got, as_f32(jax_ref.gemm_ref(ja, jb)), **tol)


@pytest.mark.parametrize("block", [(32, 32, 32), (64, 128, 32),
                                   (128, 64, 256)])
def test_gemm_block_sweep_matches_pallas(block):
    rng = np.random.default_rng(0)
    a, b = rand(rng, (160, 96)), rand(rng, (96, 224))
    tile = launch_config(gpu_lowering(block, 160, 224, 96),
                         torch.float32).tile
    got = as_f32(gemm(to_torch(a), to_torch(b), tile=tile))
    want = jax_gemm(to_jax(a), to_jax(b), block=block, interpret=True)
    np.testing.assert_allclose(got, as_f32(want), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["", "sigmoid", "tanh", "relu"])
@pytest.mark.parametrize("m,n,k", [(96, 80, 64), (130, 70, 190)])
def test_gemm_bias_act_matches_pallas(m, n, k, fn, dtype):
    """K2's CPU path against the fused Pallas kernel (interpret mode) and
    the JAX oracle; (96, 80, 64) is ``tests/test_kernels.py``'s shape, the
    other one is ragged against the (128, 128, 128) block."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1 + m + n + k)
    a, b, bias = rand(rng, (m, k)), rand(rng, (k, n)), rand(rng, (n,))
    got = gemm_bias_act(to_torch(a, tdt), to_torch(b, tdt), to_torch(bias),
                        fn=fn)
    assert got.dtype == tdt
    got = as_f32(got)
    ja, jb, jbias = to_jax(a, jdt), to_jax(b, jdt), to_jax(bias)
    want = jax_gemm_bias_act(ja, jb, jbias, fn=fn, block=(128, 128, 128),
                             interpret=True)
    np.testing.assert_allclose(got, as_f32(want), **tol)
    np.testing.assert_allclose(
        got, as_f32(jax_ref.gemm_bias_act_ref(ja, jb, jbias, fn=fn)), **tol)
    # a bias in the input type is widened to f32, as the JAX kernel does
    np.testing.assert_allclose(
        as_f32(gemm_bias_act(to_torch(a, tdt), to_torch(b, tdt),
                             to_torch(bias, tdt), fn=fn)),
        as_f32(ref.gemm_bias_act_ref(to_torch(a, tdt), to_torch(b, tdt),
                                     to_torch(bias, tdt).float(), fn)),
        rtol=0, atol=0)


@pytest.mark.parametrize("B,E,H", [(4, 16, 32), (8, 64, 64), (3, 10, 50)])
def test_gru_cell_matches_pallas(B, E, H):
    rng = np.random.default_rng(B + E + H)
    p = make_gru_params(rng, E, H)
    x, h = rand(rng, (B, E)), rand(rng, (B, H))
    got = as_f32(gru_cell(to_torch(x), to_torch(h),
                          {n: to_torch(v) for n, v in p.items()}))
    jp = {n: to_jax(v) for n, v in p.items()}
    want = jax_gru_cell(to_jax(x), to_jax(h), jp, block=(4, 32),
                        interpret=True)
    np.testing.assert_allclose(got, as_f32(want), **F32_TOL)
    np.testing.assert_allclose(
        got, as_f32(jax_ref.gru_cell_ref(to_jax(x), to_jax(h), jp)),
        **F32_TOL)


def test_gru_seq_matches_pallas():
    rng = np.random.default_rng(9)
    T, B, E, H = 5, 4, 12, 24
    p = make_gru_params(rng, E, H)
    xs, h0 = rand(rng, (T, B, E)), rand(rng, (B, H))
    got = as_f32(gru_seq(to_torch(xs), to_torch(h0),
                         {n: to_torch(v) for n, v in p.items()}))
    jp = {n: to_jax(v) for n, v in p.items()}
    want = jax_gru_seq(to_jax(xs), to_jax(h0), jp, block=(4, 24),
                       interpret=True)
    np.testing.assert_allclose(got, as_f32(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got, as_f32(jax_ref.gru_seq_ref(to_jax(xs), to_jax(h0), jp)),
        rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# The slice end to end on the CPU
# --------------------------------------------------------------------------- #


def test_scheduled_gemm_matches_jax_package():
    rng = np.random.default_rng(2)
    a, b = rand(rng, (192, 64)), rand(rng, (64, 160))
    got, cfg = scheduled_gemm(to_torch(a), to_torch(b))
    want = jax_ops.scheduled_gemm(to_jax(a), to_jax(b), interpret=True)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **F32_TOL)
    assert cfg.block == (192, 160, 64)


def test_fused_gru_matches_jax_package():
    rng = np.random.default_rng(9)
    T, B, E, H = 5, 4, 12, 24
    p = make_gru_params(rng, E, H)
    xs, h0 = rand(rng, (T, B, E)), rand(rng, (B, H))
    model = FusedGRU.from_numpy(p, device="cpu")
    got = model(to_torch(xs), to_torch(h0))
    (bb, bh), _ = plan_gru(B, H, E)
    want = jax_gru_seq(to_jax(xs), to_jax(h0),
                       {n: to_jax(v) for n, v in p.items()},
                       block=(bb, bh), interpret=True)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=1e-4,
                               atol=1e-5)
