"""The port's recurrent schedule (paper Section 3.6) against the JAX
package's: priming, recursive and finish streams op for op, their copy
counts and modeled times, and the executed GRU's final state, on the same
seeded numpy inputs; then the behaviour tests of ``tests/test_recurrent.py``
on the port alone."""
import numpy as np
import pytest

from repro.core import instructions as jax_I
from repro.core import kernels_ir as jax_K
from repro.core import sysgraph as jax_sysgraph
from repro.core.executor import ExecutionError as JaxExecutionError
from repro.core.isel import select_instructions as jax_select
from repro.core.recurrent import execute_recurrent as jax_execute_recurrent
from repro.core.recurrent import schedule_recurrent as jax_schedule_recurrent
from repro_torch.core import instructions as I
from repro_torch.core import kernels_ir as K
from repro_torch.core import sysgraph
from repro_torch.core.executor import ExecutionError
from repro_torch.core.ir import interpret
from repro_torch.core.isel import select_instructions
from repro_torch.core.recurrent import (RecurrentSchedule, execute_recurrent,
                                        schedule_recurrent)

GRU_WEIGHTS = ["Wr", "Ur", "Wz", "Uz", "Wn", "Un", "br", "bz", "bnx", "bnh"]
STREAMS = ("prime", "recursive", "finish")
#: (graph builder name, its argument, steps): the cases of
#: ``tests/test_recurrent.py`` plus the port's default target, where both
#: packages execute 3 steps and refuse 2 and 4
#: (``test_gpu_sm_execution_fault_matches_jax_package``)
CASES = [("paper_accelerator", 2, 6), ("tpu_v5e", 1, 4), ("tpu_v5e", 2, 5),
         ("gpu_sm", 8, 3)]


def make_gru(B=4, H=16, E=12):
    prog = K.gru_cell(B, H, E)
    sel = select_instructions(prog, I.tpu_isa())
    assert sel.complete
    return prog, sel


def make_jax_gru(B=4, H=16, E=12):
    prog = jax_K.gru_cell(B, H, E)
    sel = jax_select(prog, jax_I.tpu_isa())
    assert sel.complete
    return prog, sel


def gru_inputs(prog, steps, seed):
    rng = np.random.default_rng(seed)
    w = {n: rng.uniform(-0.5, 0.5, size=prog.buffer(n).shape)
         for n in GRU_WEIGHTS}
    h0 = rng.uniform(-0.5, 0.5, size=prog.buffer("H").shape)
    xs = [{"X": rng.uniform(-0.5, 0.5, size=prog.buffer("X").shape)}
          for _ in range(steps)]
    return w, h0, xs


def ref_gru(prog, weights, h0, xs):
    h = np.asarray(h0, dtype=np.float64)
    for x in xs:
        h = interpret(prog, {**weights, "H": h, **x})["Hout"].astype(np.float64)
    return h


def op_signature(op):
    """What one scheduled op does, in plain values: kind, issuing device,
    source and destination memories, region, compute tile and its times."""
    region = None if op.region is None else (op.region.buffer,
                                             op.region.bounds)
    tile = None if op.tile is None else (
        op.tile.instr_idx, op.tile.needle_name, sorted(op.tile.offsets.items()),
        sorted(op.tile.sizes.items()), op.tile.device,
        [(nb, r.buffer, r.bounds, rd, wr) for nb, r, rd, wr in op.tile.operands])
    return (op.kind, op.device, op.src, op.dst, region, tile, op.start, op.end)


@pytest.mark.parametrize("target,arg,steps", CASES)
def test_recurrent_schedule_matches_jax_package(target, arg, steps):
    prog, sel = make_gru()
    jprog, jsel = make_jax_gru()
    rs = schedule_recurrent(sel, getattr(sysgraph, target)(arg),
                            carry={"Hout": "H"}, streamed=("X",))
    jrs = jax_schedule_recurrent(jsel, getattr(jax_sysgraph, target)(arg),
                                 carry={"Hout": "H"}, streamed=("X",))
    for name in STREAMS:
        got, want = getattr(rs, name), getattr(jrs, name)
        assert [op_signature(op) for op in got.ops] == \
            [op_signature(op) for op in want.ops], name
        assert got.makespan == want.makespan, name
        assert got.homes == want.homes, name
    assert rs.copy_counts() == jrs.copy_counts()
    for t in (1, 2, steps, 128):
        assert rs.total_time(t) == jrs.total_time(t)
    assert (rs.carry, rs.streamed) == (jrs.carry, jrs.streamed)

    w, h0, xs = gru_inputs(prog, steps, seed=5)
    got = execute_recurrent(rs, sel, xs, {**w, "H": h0})["Hout"]
    want = jax_execute_recurrent(jrs, jsel, xs, {**w, "H": h0})["Hout"]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("steps", [2, 4])
def test_gpu_sm_execution_fault_matches_jax_package(steps):
    """A reference fault the port copies: on ``gpu_sm(8)`` the finish
    stream is scheduled from the residency after one recursive stream and
    the recursive stream from the residency after priming, so a run of 2
    steps (no recursive stream) or of 4 (two) reads the carried H from an
    SM that does not hold it.  Both packages raise the same error."""
    prog, sel = make_gru()
    jprog, jsel = make_jax_gru()
    rs = schedule_recurrent(sel, sysgraph.gpu_sm(8), carry={"Hout": "H"},
                            streamed=("X",))
    jrs = jax_schedule_recurrent(jsel, jax_sysgraph.gpu_sm(8),
                                 carry={"Hout": "H"}, streamed=("X",))
    w, h0, xs = gru_inputs(prog, steps, seed=5)
    with pytest.raises(ExecutionError) as got:
        execute_recurrent(rs, sel, xs, {**w, "H": h0})
    with pytest.raises(JaxExecutionError) as want:
        jax_execute_recurrent(jrs, jsel, xs, {**w, "H": h0})
    assert str(got.value) == str(want.value)
    assert "not resident" in str(got.value)


@pytest.mark.parametrize("target,arg,steps", CASES)
def test_recurrent_gru_matches_oracle(target, arg, steps):
    prog, sel = make_gru()
    rs = schedule_recurrent(sel, getattr(sysgraph, target)(arg),
                            carry={"Hout": "H"}, streamed=("X",))
    w, h0, xs = gru_inputs(prog, steps, seed=5)
    got = execute_recurrent(rs, sel, xs, {**w, "H": h0})["Hout"]
    np.testing.assert_allclose(got, ref_gru(prog, w, h0, xs),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("target,arg", [("paper_accelerator", 2),
                                        ("tpu_v5e", 1), ("gpu_sm", 8)])
def test_recursive_stream_elides_weight_copies(target, arg):
    """The paper's persistent-weights win on the modeled targets at a GRU
    whose weights fit on chip: the steady-state stream re-fetches no weight
    that stayed resident after priming."""
    prog, sel = make_gru()
    rs = schedule_recurrent(sel, getattr(sysgraph, target)(arg),
                            carry={"Hout": "H"}, streamed=("X",))

    def weight_copies(s):
        return sum(1 for op in s.ops if op.kind == "copy"
                   and op.region.buffer in GRU_WEIGHTS)
    assert weight_copies(rs.prime) > 0
    assert weight_copies(rs.recursive) == 0
    assert rs.recursive.makespan < rs.prime.makespan


def test_total_time_formula():
    prog, sel = make_gru(2, 8, 8)
    rs = schedule_recurrent(sel, sysgraph.tpu_v5e(1), carry={"Hout": "H"},
                            streamed=("X",))
    assert isinstance(rs, RecurrentSchedule)
    assert rs.total_time(10) == pytest.approx(rs.prime.makespan
                                              + 8 * rs.recursive.makespan
                                              + rs.finish.makespan)
    assert rs.total_time(1) == rs.prime.makespan + rs.finish.makespan


def test_single_step_runs_prime_and_finish():
    prog, sel = make_gru(2, 8, 8)
    rs = schedule_recurrent(sel, sysgraph.tpu_v5e(1), carry={"Hout": "H"},
                            streamed=("X",))
    w, h0, xs = gru_inputs(prog, 2, seed=0)
    got = execute_recurrent(rs, sel, xs, {**w, "H": h0})["Hout"]
    np.testing.assert_allclose(got, ref_gru(prog, w, h0, xs),
                               rtol=1e-4, atol=1e-5)
