"""K3's and K4's launch plans on the CPU: the split step's partial sums and
the hoisted sequence against the JAX package's Pallas kernels (interpret
mode), in f32 and bf16, K3's split rule and route, K4's route rule and its
partition of the card (for f32 and bf16 operands), the step route's plain
path, and the packing of K4's operands."""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.gru import gru_cell as jax_gru_cell
from repro.kernels.gru import gru_seq as jax_gru_seq
from repro_torch.kernels import ref
from repro_torch.kernels.cuda import CSRC, MAX_SMEM_BYTES
from repro_torch.kernels.gemm import H100_SMS
from repro_torch.kernels import gru as gru_mod
from repro_torch.kernels.gru import (C_CONSTANTS, CONSTANTS_ARGTYPES,
                                     OCCUPANCY_ARGTYPES, PARAM_NAMES,
                                     SEQ_ARGTYPES, SEQ_KC, SEQ_MAX_B,
                                     SEQ_MAX_LANES, SEQ_RB, SEQ_STAGES,
                                     SEQ_THREADS, STEP_ARGTYPES,
                                     STEP_BLOCKS_PER_SM, STEP_KC, TILE_B,
                                     TILE_H, FusedGRU, gru_cell, gru_seq,
                                     gru_seq_launch, gru_seq_steps,
                                     gru_split, pack_u, pack_w, seq_route,
                                     split_cost, step_route)
from repro_torch.kernels.ops import gru_tile, plan_gru, scheduled_gru

DEEPBENCH_GRU = [(32, 512), (32, 1024), (16, 1536), (32, 1792)]
#: ragged (B, E, H): batch not a multiple of 4, E != H, H not a multiple
#: of 4 nor of the block count
RAGGED = [(1, 5, 7), (3, 12, 50), (17, 40, 33), (3, 70, 130)]
CELL_TOL = dict(rtol=1e-5, atol=1e-5)       # tests/test_kernels.py
SEQ_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)       # tests/test_kernels.py, bf16


def rand(rng, shape):
    return rng.uniform(-1, 1, size=shape).astype(np.float32)


def make_params(rng, E, H):
    """Uniform(-1/sqrt(H), 1/sqrt(H)), PyTorch's own GRU init, in f32."""
    return {n: rand(rng, (E, H) if n[0] == "W" else (H, H) if n[0] == "U"
                    else (H,)) * np.float32(H ** -0.5) for n in PARAM_NAMES}


def torch_params(p):
    return {n: torch.from_numpy(v) for n, v in p.items()}


def jax_params(p, dtype=jnp.float32):
    return {n: jnp.asarray(v, dtype=dtype) for n, v in p.items()}


#: the operand dtypes of both packages: f32, and bf16 (both round the same
#: f32 numpy values to nearest even, so they start from the same bits)
DTYPES = [(torch.float32, jnp.float32, SEQ_TOL),
          (torch.bfloat16, jnp.bfloat16, BF16_TOL)]
DTYPE_IDS = ["f32", "bf16"]


def both(x, tdt, jdt):
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, dtype=jdt)


def as_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


# --------------------------------------------------------------------------- #
# K3: the split step against the Pallas kernel
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("B,E,H", RAGGED + [(8, 64, 64)])
@pytest.mark.parametrize("split", [1, 2, 3, 7])
def test_split_step_matches_pallas(B, E, H, split):
    rng = np.random.default_rng(B * 100 + E + H)
    p = make_params(rng, E, H)
    x, h = rand(rng, (B, E)), rand(rng, (B, H))
    got = ref.gru_cell_split_ref(torch.from_numpy(x), torch.from_numpy(h),
                                 torch_params(p), STEP_KC, split).numpy()
    jp = jax_params(p)
    want = jax_gru_cell(jnp.asarray(x), jnp.asarray(h), jp, block=(4, 32),
                        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **CELL_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.gru_cell_ref(jnp.asarray(x), jnp.asarray(h),
                                             jp)), **CELL_TOL)


@pytest.mark.parametrize("e,h", [(5, 7), (32, 32), (40, 33), (1792, 1792),
                                 (70, 130)])
@pytest.mark.parametrize("split", [1, 2, 5, 200])
def test_k_slices_cover_the_reduction_once(e, h, split):
    """Every row of x and of h lies in exactly one slice, the slices follow
    each other in order, and each boundary is a chunk boundary."""
    slices = ref.gru_k_slices(e, h, STEP_KC, split)
    assert len(slices) == split
    for n, part in ((e, 0), (h, 1)):
        seen = np.zeros(n, int)
        last = 0
        for sl in slices:
            b, end = sl[part]
            if b < end:
                assert b == last and b % STEP_KC == 0
                seen[b:end] += 1
                last = end
        assert (seen == 1).all()


# --------------------------------------------------------------------------- #
# K4: the hoisted sequence against the Pallas kernel
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("B,E,H", RAGGED)
def test_hoisted_sequence_matches_pallas(T, B, E, H):
    rng = np.random.default_rng(T * 1000 + B + E + H)
    p = make_params(rng, E, H)
    xs, h0 = rand(rng, (T, B, E)), rand(rng, (B, H))
    got = ref.gru_seq_hoisted_ref(torch.from_numpy(xs), torch.from_numpy(h0),
                                  torch_params(p)).numpy()
    jp = jax_params(p)
    want = jax_gru_seq(jnp.asarray(xs), jnp.asarray(h0), jp, block=(4, 32),
                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **SEQ_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.gru_seq_ref(jnp.asarray(xs),
                                            jnp.asarray(h0), jp)), **SEQ_TOL)
    # the CPU path of the wrapper is the hoisted plain version
    torch.testing.assert_close(
        gru_seq(torch.from_numpy(xs), torch.from_numpy(h0), torch_params(p)),
        torch.from_numpy(got), rtol=0, atol=0)


@pytest.mark.parametrize("tdt,jdt,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("B,E,H", RAGGED + [(8, 64, 64)])
def test_cell_matches_pallas_in_dtype(tdt, jdt, tol, B, E, H):
    """The port's ``gru_cell`` (its CPU path) against the JAX Pallas kernel
    in interpret mode, in f32 and bf16: the output in the operand dtype,
    within JAX's tolerance of that dtype (for f32 the step's 1e-5)."""
    rng = np.random.default_rng(B + 3 * E + H)
    p = make_params(rng, E, H)
    x, h = rand(rng, (B, E)), rand(rng, (B, H))
    (tx, jx), (th, jh) = both(x, tdt, jdt), both(h, tdt, jdt)
    tp = {n: v.to(tdt) for n, v in torch_params(p).items()}
    got = gru_cell(tx, th, tp, tile=(16, 16))
    want = jax_gru_cell(jx, jh, jax_params(p, jdt), block=(4, 32),
                        interpret=True)
    assert got.dtype == tdt and want.dtype == jdt
    np.testing.assert_allclose(as_np(got), as_np(want),
                               **(CELL_TOL if tdt == torch.float32 else tol))


@pytest.mark.parametrize("tdt,jdt,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("T,B,E,H", [(5, 3, 12, 50), (4, 17, 40, 33),
                                     (12, 8, 64, 64)])
def test_sequence_routes_match_pallas_in_dtype(tdt, jdt, tol, T, B, E, H):
    """Both routes' plain paths against the JAX ``gru_seq`` (a scan of the
    Pallas kernel, interpret mode), in f32 and bf16: the persistent route's
    hoisted version (``gru_seq`` on a CPU tensor, G kept in f32, h rounded
    to the operand type every step) and the step route's loop of K3
    (``gru_seq_steps``)."""
    rng = np.random.default_rng(T + B + E + H)
    p = make_params(rng, E, H)
    xs, h0 = rand(rng, (T, B, E)), rand(rng, (B, H))
    (txs, jxs), (th0, jh0) = both(xs, tdt, jdt), both(h0, tdt, jdt)
    tp = {n: v.to(tdt) for n, v in torch_params(p).items()}
    want = jax_gru_seq(jxs, jh0, jax_params(p, jdt), block=(4, 32),
                       interpret=True)
    assert seq_route(B, E, H, tdt) == "persistent"
    for got in (gru_seq(txs, th0, tp), gru_seq_steps(txs, th0, tp)):
        assert got.dtype == tdt
        np.testing.assert_allclose(as_np(got), as_np(want), **tol)


def test_bf16_sequence_rounds_h_every_step():
    """The hoisted plain version carries h in bf16 between steps, as the
    JAX scan does: it equals the loop of bf16 steps, which a sequence that
    kept h in f32 would not."""
    rng = np.random.default_rng(21)
    T, B, E, H = 16, 4, 24, 40
    p = {n: v.to(torch.bfloat16)
         for n, v in torch_params(make_params(rng, E, H)).items()}
    xs = torch.from_numpy(rand(rng, (T, B, E))).bfloat16()
    h0 = torch.from_numpy(rand(rng, (B, H))).bfloat16()
    got = ref.gru_seq_hoisted_ref(xs, h0, p)
    np.testing.assert_allclose(as_np(got), as_np(ref.gru_seq_ref(xs, h0, p)),
                               rtol=1e-2, atol=1e-2)
    fp = {n: v.float() for n, v in p.items()}
    h = h0.float()
    for x in xs:                            # the same steps, h kept in f32
        h = ref.gru_cell_ref(x.float(), h, fp)
    assert not torch.equal(got, h.bfloat16())


def test_gru_seq_takes_the_step_route_where_the_rule_says(monkeypatch):
    """``gru_seq`` asks ``seq_route`` before anything runs; on ``step`` it
    runs the loop of K3 (here its plain version on the CPU)."""
    rng = np.random.default_rng(22)
    T, B, E, H = 4, 3, 12, 20
    p = torch_params(make_params(rng, E, H))
    xs = torch.from_numpy(rand(rng, (T, B, E)))
    h0 = torch.from_numpy(rand(rng, (B, H)))
    asked = []

    def step(*args):
        asked.append(args)
        return "step"

    monkeypatch.setattr(gru_mod, "seq_route", step)
    got = gru_seq(xs, h0, p)
    assert asked == [(B, E, H, torch.float32, H100_SMS, MAX_SMEM_BYTES)]
    torch.testing.assert_close(got, gru_seq_steps(xs, h0, p), rtol=0, atol=0)
    torch.testing.assert_close(got, ref.gru_seq_ref(xs, h0, p), rtol=0,
                               atol=0)


def test_fused_gru_carries_bf16_parameters():
    rng = np.random.default_rng(23)
    p = make_params(rng, 6, 10)
    model = FusedGRU.from_numpy(p, device="cpu", dtype=torch.bfloat16)
    for n in PARAM_NAMES:
        assert getattr(model, n).dtype == torch.bfloat16
        torch.testing.assert_close(getattr(model, n),
                                   torch.from_numpy(p[n]).bfloat16(),
                                   rtol=0, atol=0)


def test_projection_folds_bnx_but_not_bnh():
    """G carries br, bz, bnx; a bias bnh moved into G changes the result
    (it sits inside r (..)), which is why the kernel keeps it."""
    rng = np.random.default_rng(11)
    T, B, E, H = 3, 2, 6, 5
    p = torch_params(make_params(rng, E, H))
    p["bnh"] = p["bnh"] + 1.0
    xs, h0 = torch.from_numpy(rand(rng, (T, B, E))), \
        torch.from_numpy(rand(rng, (B, H)))
    want = ref.gru_seq_ref(xs, h0, p)
    torch.testing.assert_close(ref.gru_seq_hoisted_ref(xs, h0, p), want)
    moved = dict(p, bnx=p["bnx"] + p["bnh"], bnh=torch.zeros(H))
    assert not torch.allclose(ref.gru_seq_hoisted_ref(xs, h0, moved), want,
                              rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# K3's split rule and route
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("batch,hidden", DEEPBENCH_GRU)
def test_deepbench_steps_fill_the_card(batch, hidden):
    """At the compiler's tile every DeepBench step launches at least one
    block per SM of an H100 (132), each slice at least one chunk deep, and
    takes 16-byte copies."""
    tile = gru_tile(plan_gru(batch, hidden, hidden)[0])
    split = gru_split(batch, hidden, hidden, tile, H100_SMS)
    tiles = -(-hidden // tile[1]) * -(-batch // tile[0])
    assert tiles * split >= H100_SMS
    assert split <= 2 * -(-hidden // STEP_KC)
    assert step_route(hidden, hidden) == "vec4"


@pytest.mark.parametrize("B,E,H", RAGGED + [(32, 4096, 4096)])
@pytest.mark.parametrize("tile", [(bb, bh) for bb in TILE_B for bh in TILE_H])
@pytest.mark.parametrize("sms", [1, 8, H100_SMS])
@pytest.mark.parametrize("per_sm", [1, STEP_BLOCKS_PER_SM, 3])
def test_split_rule(B, E, H, tile, sms, per_sm):
    """The split is the count of least modeled cost among those that keep
    a chunk a slice, at the resident blocks a SM the card reports; where
    the tiles fill whole waves it is 1."""
    split = gru_split(B, E, H, tile, sms, per_sm)
    tiles = -(-H // tile[1]) * -(-B // tile[0])
    chunks = -(-E // STEP_KC) + -(-H // STEP_KC)
    most = chunks
    assert 1 <= split <= most
    cost = split_cost(B, E, H, tiles, split, sms, per_sm)
    assert all(cost <= split_cost(B, E, H, tiles, s, sms, per_sm)
               for s in range(1, most + 1))
    if tiles % (per_sm * sms) == 0:   # whole waves already
        assert split == 1
    assert split == gru_split(B, E, H, tile, sms, per_sm)  # a pure function


def test_split_cost_counts_waves_and_partials():
    # 112 tiles on 132 SMs x 2 blocks: 7 slices fill 3 waves of 264 almost
    # exactly; 3 slices need 2 waves for 336 blocks
    assert split_cost(32, 1792, 1792, 112, 7) < split_cost(32, 1792, 1792,
                                                           112, 3)
    # one whole wave and no partials: the model's floor, 1
    assert split_cost(32, 64, 64, 264, 1) == 1.0
    # the partials' bytes count: at equal waves more slices cost more
    assert split_cost(32, 64, 64, 132, 2) < split_cost(32, 64, 64, 66, 4)


def test_step_route():
    assert step_route(512, 512) == "vec4"
    assert step_route(512, 512, aligned=False) == "scalar"
    assert step_route(12, 50) == "scalar"
    assert step_route(5, 8) == "scalar"


# --------------------------------------------------------------------------- #
# K4's partition of the card
# --------------------------------------------------------------------------- #


def assert_partition(B, E, H, sms, smem):
    ln = gru_seq_launch(B, E, H, sms, smem)
    assert 1 <= ln.blocks <= sms
    # the columns cover H exactly once
    cover = np.zeros(ln.blocks * ln.cols, int)
    for blk in range(ln.blocks):
        cover[blk * ln.cols:(blk + 1) * ln.cols] += 1
    assert (cover[:H] == 1).all() and ln.blocks * ln.cols - H < ln.cols
    # a launch's batch rows: all of B up to SEQ_MAX_B, else groups, halved
    # to whole row groups where a block cannot hold more
    assert 1 <= ln.batch <= min(B, SEQ_MAX_B)
    assert ln.batch == min(B, SEQ_MAX_B) or ln.batch % SEQ_RB == 0
    rg = -(-ln.batch // SEQ_RB)
    assert ln.lanes & (ln.lanes - 1) == 0 and ln.lanes <= SEQ_MAX_LANES
    assert ln.cols * rg * ln.lanes <= ln.threads == SEQ_THREADS
    assert SEQ_KC % (4 * ln.lanes) == 0
    assert ln.hp % SEQ_KC == 0 and H <= ln.hp < H + SEQ_KC
    assert ln.smem_bytes <= smem <= MAX_SMEM_BYTES
    assert ln.rows_on_chip == ln.hp or ln.rows_on_chip % SEQ_KC == 0
    assert 0 <= ln.rows_on_chip <= ln.hp
    resident = ln.rows_on_chip == ln.hp
    # the ring: SEQ_STAGES chunks of h, and of U where U is not all resident
    stage = SEQ_RB * rg * (SEQ_KC + 4) + (0 if resident
                                          else SEQ_KC * 3 * ln.cols)
    staging = 4 * max(SEQ_STAGES * stage, ln.lanes * ln.cols * rg * 3 * SEQ_RB)
    assert ln.smem_bytes >= 4 * ln.rows_on_chip * 3 * ln.cols + staging
    if not resident:                   # not one chunk more would fit
        assert 4 * (ln.rows_on_chip + SEQ_KC) * 3 * ln.cols + staging > smem
    assert ln.u_bytes == 12 * H * H
    assert ln.u_bytes_on_chip == 12 * H * min(ln.rows_on_chip, H)
    assert ln == gru_seq_launch(B, E, H, sms, smem)     # a pure function
    return ln


@pytest.mark.parametrize("batch,hidden", DEEPBENCH_GRU)
def test_deepbench_partition(batch, hidden):
    """128 blocks on an H100; U stays in shared memory whole up to
    H = 1024 and in part (beside a ring that also streams U) above."""
    ln = assert_partition(batch, hidden, hidden, H100_SMS, MAX_SMEM_BYTES)
    assert ln.blocks == 128 and ln.batch == batch      # one launch
    if hidden <= 1024:
        assert ln.rows_on_chip == ln.hp == hidden
        assert ln.u_bytes_on_chip == ln.u_bytes
    else:
        assert 0 < ln.rows_on_chip < hidden
        assert 0 < ln.u_bytes_on_chip < ln.u_bytes


def least_smem(rows, cols):
    """The least shared memory a block needs for ``rows`` batch rows: the
    ring with U and no row of U resident (the k-lane sums fit in it)."""
    return 4 * SEQ_STAGES * (SEQ_RB * -(-rows // SEQ_RB) * (SEQ_KC + 4)
                             + SEQ_KC * 3 * cols)


@pytest.mark.parametrize("B,E,H", RAGGED + [(64, 8, 200), (4, 3, 4096),
                                            (65, 8, 200), (300, 16, 1792)])
@pytest.mark.parametrize("sms,smem", [(1, MAX_SMEM_BYTES), (7, 48 * 1024),
                                      (H100_SMS, MAX_SMEM_BYTES),
                                      (1000, 48 * 1024)])
def test_ragged_partition(B, E, H, sms, smem):
    cols, rows = -(-H // sms), min(B, SEQ_MAX_B)
    small = min(rows, SEQ_RB)       # the fewest rows a launch is cut to
    if cols * -(-small // SEQ_RB) > SEQ_THREADS:
        with pytest.raises(ValueError, match="threads"):
            gru_seq_launch(B, E, H, sms, smem)
        return
    try:
        ln = assert_partition(B, E, H, sms, smem)
    except ValueError as exc:
        # only all of U resident, with a ring of h, could fit, and does not
        assert "shared memory" in str(exc) and least_smem(small, cols) > smem
        return
    if ln.batch < rows:             # the whole group did not fit
        assert cols * -(-rows // SEQ_RB) > SEQ_THREADS \
            or least_smem(rows, cols) > smem
    if least_smem(ln.batch, cols) > smem:
        assert ln.rows_on_chip == ln.hp


def c_seq_smem_bytes(B, cpb, rows_res, lanes, hp, esize):
    """``csrc/gru.cu``'s seq_smem_bytes, the layout its C entry demands,
    transcribed: the resident panel rows rounded up to 16 bytes, then the
    larger of the ring (h rows of SEQ_KC + a 16-byte pad, and U rows where
    not all resident) and the k-lanes' f32 sums."""
    rg, row = -(-B // SEQ_RB), 3 * cpb
    stage = rg * SEQ_RB * (SEQ_KC + 16 // esize) \
        + (SEQ_KC * row if rows_res < hp else 0)
    ring = SEQ_STAGES * stage * esize
    red = 4 * lanes * cpb * rg * 3 * SEQ_RB
    return -(-rows_res * row * esize // 16) * 16 + max(ring, red)


def test_seq_smem_bytes_is_transcribed_from_the_source():
    src = (CSRC / "gru.cu").read_text()
    body = re.search(r"static long long seq_smem_bytes\((.*?)\n\}", src,
                     re.S).group(1)
    for piece in ("kSeqKC + 16 / esize", "kSeqStages * stage * esize",
                  "4LL * lanes * cpb * rg * 3 * kSeqRB",
                  "(rows_res * row * esize + 15) / 16 * 16"):
        assert piece in body


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,E,H", [(b, h, h) for b, h in DEEPBENCH_GRU]
                         + RAGGED + [(65, 8, 200), (8, 512, 3072),
                                     (8, 512, 9504), (64, 16, 19536)])
def test_partition_fits_seq_smem_bytes(dtype, B, E, H):
    """Every partition, f32 or bf16, gives the C entry exactly the shared
    memory its layout asks for, within the card's limit."""
    if seq_route(B, E, H, dtype) == "step":
        assert dtype == torch.float32 and H == 19536
        return
    ln = gru_seq_launch(B, E, H, dtype=dtype)
    esize = dtype.itemsize
    assert ln.smem_bytes == c_seq_smem_bytes(ln.batch, ln.cols,
                                             ln.rows_on_chip, ln.lanes,
                                             ln.hp, esize) <= MAX_SMEM_BYTES
    assert ln.u_bytes == esize * 3 * H * H
    assert ln.u_bytes_on_chip == esize * 3 * H * min(ln.rows_on_chip, H)
    if ln.rows_on_chip < ln.hp:      # not one chunk more would fit
        assert c_seq_smem_bytes(ln.batch, ln.cols,
                                ln.rows_on_chip + SEQ_KC, ln.lanes, ln.hp,
                                esize) > MAX_SMEM_BYTES


@pytest.mark.parametrize("batch,hidden", DEEPBENCH_GRU)
def test_bf16_deepbench_partition_keeps_all_of_u(batch, hidden):
    """Half the bytes a panel row: in bf16 every DeepBench width keeps its
    whole U panel in shared memory, on the same 128 blocks as f32."""
    f32 = gru_seq_launch(batch, hidden, hidden)
    bf16 = gru_seq_launch(batch, hidden, hidden, dtype=torch.bfloat16)
    assert (bf16.blocks, bf16.cols, bf16.batch, bf16.hp) == \
        (f32.blocks, f32.cols, f32.batch, f32.hp) == \
        (128, -(-hidden // H100_SMS), batch, hidden)
    assert bf16.rows_on_chip == hidden and bf16.u_bytes_on_chip == bf16.u_bytes
    assert 2 * bf16.u_bytes == f32.u_bytes


@pytest.mark.parametrize("B", [1, 8, 64, 300])
@pytest.mark.parametrize("dtype,last", [(torch.float32, 9504),
                                        (torch.bfloat16, 19536)],
                         ids=["f32", "bf16"])
def test_seq_route_boundary(B, dtype, last):
    """On an H100 the persistent kernel places any batch (groups of rows,
    down to SEQ_RB) up to H = 9504 in f32 and 19536 in bf16; one column
    more a block, and the sequence takes the step route."""
    assert seq_route(B, 512, last, dtype) == "persistent"
    assert gru_seq_launch(B, 512, last, dtype=dtype).batch == min(B, SEQ_RB)
    assert seq_route(B, 512, last + 1, dtype) == "step"
    with pytest.raises(ValueError, match="shared memory"):
        gru_seq_launch(B, 512, last + 1, dtype=dtype)
    # a pure function of the shapes and the card
    assert seq_route(B, 512, last, dtype, H100_SMS, MAX_SMEM_BYTES) == \
        "persistent"
    assert seq_route(B, 512, 64, dtype, sms=1) == "persistent"
    assert seq_route(B, 512, 1024, dtype, sms=1) == "step"     # threads


@pytest.mark.parametrize("batch,hidden", DEEPBENCH_GRU + [(8, 10240),
                                                           (1, 12288)])
def test_route_at_deepbench_and_wide_sizes(batch, hidden):
    want = "step" if hidden > 9504 else "persistent"
    assert seq_route(batch, hidden, hidden) == want
    assert seq_route(batch, hidden, hidden, torch.bfloat16) == "persistent"


def test_step_route_runs_k3_at_the_compilers_tile(monkeypatch):
    """Through ``FusedGRU`` (``ops.scheduled_gru``) the step route launches
    K3 once a step at the tile of the compiler's GRU plan."""
    rng = np.random.default_rng(24)
    T, B, E, H = 3, 8, 16, 40
    p = make_params(rng, E, H)
    xs = torch.from_numpy(rand(rng, (T, B, E)))
    h0 = torch.from_numpy(rand(rng, (B, H)))
    tiles = []
    real = gru_mod.gru_cell

    def cell(x, h, params, tile, out=None):
        tiles.append(tuple(tile))
        return real(x, h, params, tile, out)

    monkeypatch.setattr(gru_mod, "seq_route", lambda *a: "step")
    monkeypatch.setattr(gru_mod, "gru_cell", cell)
    got = scheduled_gru(xs, h0, FusedGRU.from_numpy(p, device="cpu"))
    want_tile = gru_tile(plan_gru(B, H, E)[0])
    assert tiles == [want_tile] * T
    torch.testing.assert_close(got, ref.gru_seq_ref(xs, h0, torch_params(p)),
                               rtol=0, atol=0)


def test_split_cost_weighs_partials_against_the_weights_bytes():
    """bf16 weights are half the bytes of f32 ones, and the f32 partials
    are not: a split costs relatively more in bf16, nothing without one."""
    assert split_cost(32, 1792, 1792, 112, 1, esize=2) == \
        split_cost(32, 1792, 1792, 112, 1)
    assert split_cost(32, 1792, 1792, 112, 7, esize=2) > \
        split_cost(32, 1792, 1792, 112, 7)
    assert gru_split(32, 1792, 1792, (32, 64)) == \
        gru_split(32, 1792, 1792, (32, 64), H100_SMS, STEP_BLOCKS_PER_SM, 4)


def test_partition_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="threads"):
        gru_seq_launch(32, 8, 8192, sms=4)
    with pytest.raises(ValueError):
        gru_seq_launch(0, 8, 8)
    # on an H100 not even SEQ_RB rows of a block fit above H = 9504
    assert gru_seq_launch(1, 8, 9504).batch == 1
    assert gru_seq_launch(64, 8, 9504).batch == SEQ_RB
    with pytest.raises(ValueError, match="shared memory"):
        gru_seq_launch(1, 8, 9505)


@pytest.mark.parametrize("B", [65, 128, 200, 1000])
@pytest.mark.parametrize("hidden", [512, 1792, 4096])
def test_large_batch_takes_groups_of_rows(B, hidden):
    """Any batch runs: SEQ_MAX_B rows a launch where a block holds them
    (every DeepBench width), fewer at wider H; ceil(B / batch) launches."""
    ln = assert_partition(B, hidden, hidden, H100_SMS, MAX_SMEM_BYTES)
    if hidden <= 1792:
        assert ln.batch == SEQ_MAX_B
    assert ln.batch % SEQ_RB == 0 and -(-B // ln.batch) >= 2


# --------------------------------------------------------------------------- #
# Packing
# --------------------------------------------------------------------------- #


def unpack_u(packed, H):
    """``pack_u``'s inverse: (Ur, Uz, Un)."""
    blocks, hp, _, cols = packed.shape
    u = packed.permute(2, 1, 0, 3).reshape(3, hp, blocks * cols)[:, :H, :H]
    return tuple(m.contiguous() for m in u)


@pytest.mark.parametrize("B,E,H", RAGGED + [(32, 64, 1792)])
def test_packing_round_trip(B, E, H):
    rng = np.random.default_rng(E + H)
    p = torch_params(make_params(rng, E, H))
    ln = gru_seq_launch(B, E, H)
    packed = pack_u(p, ln)
    assert tuple(packed.shape) == (ln.blocks, ln.hp, 3, ln.cols)
    assert packed.is_contiguous()
    for got, name in zip(unpack_u(packed, H), ("Ur", "Uz", "Un")):
        torch.testing.assert_close(got, p[name], rtol=0, atol=0)
    # the padding is zeros, and the last block's panel holds its columns
    full = packed.permute(2, 1, 0, 3).reshape(3, ln.hp, ln.blocks * ln.cols)
    assert not full[:, H:].any() and not full[:, :, H:].any()
    blk = ln.blocks - 1
    torch.testing.assert_close(
        packed[blk, :H, 0, :H - blk * ln.cols], p["Ur"][:, blk * ln.cols:],
        rtol=0, atol=0)
    w, bias = pack_w(p)
    assert tuple(w.shape) == (E, 3 * H) and tuple(bias.shape) == (3 * H,)
    for i, (wn, bn) in enumerate((("Wr", "br"), ("Wz", "bz"), ("Wn", "bnx"))):
        torch.testing.assert_close(w[:, i * H:(i + 1) * H], p[wn], rtol=0,
                                   atol=0)
        torch.testing.assert_close(bias[i * H:(i + 1) * H], p[bn], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("B,E,H", [(3, 12, 50), (17, 40, 33)])
def test_block_panels_give_the_recurrence(B, E, H):
    """The sequence as the kernel's blocks compute it, one panel each, on
    the CPU: each block's h @ panel gives its columns of h [Ur|Uz|Un], and
    the steps agree with the plain version."""
    rng = np.random.default_rng(B + H)
    p = torch_params(make_params(rng, E, H))
    T = 4
    xs, h = torch.from_numpy(rand(rng, (T, B, E))), \
        torch.from_numpy(rand(rng, (B, H)))
    want = ref.gru_seq_ref(xs, h, p)
    ln = gru_seq_launch(B, E, H, sms=7)
    packed = pack_u(p, ln)
    w, bias = pack_w(p)
    g = (xs.reshape(T * B, E) @ w + bias).view(T, B, 3 * H)
    for t in range(T):
        hp = torch.zeros(B, ln.hp)
        hp[:, :H] = h
        hu = torch.cat([(hp @ packed[i].reshape(ln.hp, 3 * ln.cols))
                        .view(B, 3, ln.cols) for i in range(ln.blocks)], 2)
        hu = hu[:, :, :H]
        r = torch.sigmoid(g[t, :, :H] + hu[:, 0])
        z = torch.sigmoid(g[t, :, H:2 * H] + hu[:, 1])
        n = torch.tanh(g[t, :, 2 * H:] + r * (hu[:, 2] + p["bnh"]))
        h = (1 - z) * n + z * h
    torch.testing.assert_close(h, want, **SEQ_TOL)


@pytest.mark.parametrize("name,argtypes", [
    ("repro_gru_cell", STEP_ARGTYPES), ("repro_gru_seq", SEQ_ARGTYPES),
    ("repro_gru_cell_occupancy", OCCUPANCY_ARGTYPES),
    ("repro_gru_constants", CONSTANTS_ARGTYPES)])
def test_bindings_match_the_c_entries(name, argtypes):
    """The ctypes argument list of each C entry of csrc/gru.cu: an int for
    each ``int`` parameter, a pointer for each ``void*``, in order."""
    src = (CSRC / "gru.cu").read_text()
    sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    params = [p.strip() for p in sig.split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert argtypes == want


def test_mirrored_constants_match_the_source():
    """The constants the launch plans copy are csrc/gru.cu's (the wrapper
    also asks the built library, ``repro_gru_constants``, on the card)."""
    src = (CSRC / "gru.cu").read_text()
    names = ("kStepKC", "kSeqThreads", "kSeqKC", "kSeqStages", "kSeqRB",
             "kSeqMaxB")
    got = tuple(int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                for n in names)
    assert got == C_CONSTANTS
    body = re.search(r'extern "C" int repro_gru_constants\(void\* out\) \{'
                     r'(.*?)\n\}', src, re.S).group(1)
    assert re.findall(r"o\[(\d)\] = (\w+);", body) == \
        [(str(i), n) for i, n in enumerate(names)]
