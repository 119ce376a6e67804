"""The port's fabric tier (``repro_torch.fabric``, with the restored modelled
targets, ``compile_fabric``, the fabric search space and tuner suite, and
``verify.fabric``) against the JAX package's, on the cases of
``tests/test_fabric.py``: every topology, partition, collective plan,
closed-form cost, simulated makespan and evaluator score is equal — exactly,
not within a tolerance, since both sides run the same numpy-only logic."""
import dataclasses

import pytest

from repro.compile import compile_fabric as jax_compile_fabric
from repro.core import sysgraph as jax_sysgraph
from repro.fabric import collectives as jax_coll
from repro.fabric import partition as jax_part
from repro.fabric import simulate as jax_sim
from repro.fabric import topology as jax_topo
from repro.search.space import SearchSpace as JaxSearchSpace
from repro.search.space import sysgraph_fingerprint as jax_sysgraph_fp
from repro.search.tune import tune_fabric_case as jax_tune_fabric_case
from repro_torch.compile import compile_fabric
from repro_torch.compile.keys import sysgraph_fingerprint
from repro_torch.core import sysgraph
from repro_torch.fabric import collectives as coll
from repro_torch.fabric import partition as part
from repro_torch.fabric import simulate as sim
from repro_torch.fabric import topology as topo
from repro_torch.search.space import ParamApproach, SearchSpace
from repro_torch.search.strategies import STRATEGIES
from repro_torch.search.tune import fabric_record_for, tune_fabric_case
from repro_torch.verify import verify_fabric, verify_partition

PORT = dict(topo=topo, part=part, sim=sim, coll=coll)
JAX = dict(topo=jax_topo, part=jax_part, sim=jax_sim, coll=jax_coll)
BOTH = [PORT, JAX]


def both(fn):
    """``fn`` on the port's modules and on the JAX package's."""
    return [fn(**mods) for mods in BOTH]


# --------------------------------------------------------------------------- #
# The modelled targets
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name,args", [
    ("tpu_v5e", (1,)), ("tpu_v5e", (4,)), ("paper_accelerator", (2,)),
    ("gpu_sm", (8,))])
def test_sysgraph_fingerprints_match_jax_package(name, args):
    g = getattr(sysgraph, name)(*args)
    ref = getattr(jax_sysgraph, name)(*args)
    assert sysgraph_fingerprint(g) == jax_sysgraph_fp(ref)
    assert g.name == ref.name and g.family == ref.family


def test_v5e_constants_are_the_jax_packages():
    for name in ("V5E_PEAK_FLOPS", "V5E_HBM_BW", "V5E_HBM_BYTES",
                 "V5E_VMEM_BYTES", "V5E_ICI_BW", "V5E_CLOCK"):
        assert getattr(sysgraph, name) == getattr(jax_sysgraph, name), name


@pytest.mark.parametrize("name", ["tpu_v5e", "v5e", "tpu", "gpu_sm", "gpu",
                                  "paper"])
def test_resolve_target_matches_jax_package(name):
    assert sysgraph_fingerprint(sysgraph.resolve_target(name)) == \
        jax_sysgraph_fp(jax_sysgraph.resolve_target(name))


# --------------------------------------------------------------------------- #
# Topology
# --------------------------------------------------------------------------- #


def _topology(t):
    return (t.name, t.n_chips, t.ring_order,
            [dataclasses.astuple(l) for l in t.links])


TOPOLOGIES = [("ring", (4,)), ("ring", (2,)), ("ring", (1,)), ("ring", (3,)),
              ("torus", (2, 2)), ("torus", (4, 4)), ("torus", (1, 4)),
              ("host_tree", (4,))]


@pytest.mark.parametrize("factory,args", TOPOLOGIES)
def test_topology_matches_jax_package(factory, args):
    port, ref = both(lambda topo, **_: getattr(topo, factory)(*args))
    assert _topology(port) == _topology(ref)
    assert port.min_link_bandwidth() == ref.min_link_bandwidth()
    assert sysgraph_fingerprint(port.build_graph()) == \
        jax_sysgraph_fp(ref.build_graph())
    n = port.n_chips
    for a in range(n):
        for b in range(n):
            assert [dataclasses.astuple(l) for l in port.path(a, b)] == \
                [dataclasses.astuple(l) for l in ref.path(a, b)]


def test_ring_bonds_ici_ports():
    t = topo.ring(4)
    assert len(t.links) == 8
    assert {l.bandwidth for l in t.links} == {100e9}
    assert topo.ring(2).links[0].bandwidth == 200e9
    assert len(topo.ring(1).links) == 0


def test_build_graph_matches_tpu_v5e_wiring():
    g = topo.ring(3).build_graph()
    ref = sysgraph.tpu_v5e(3)
    assert set(g.memories) == set(ref.memories)
    assert {(e.src, e.dst, e.issuer) for e in g.edges} == \
        {(e.src, e.dst, e.issuer) for e in ref.edges}


@pytest.mark.parametrize("name,n", [("ring", 4), ("torus", 8), ("host", 2),
                                    ("torus", 9)])
def test_make_topology_matches_jax_package(name, n):
    port, ref = both(lambda topo, **_: topo.make_topology(name, n))
    assert _topology(port) == _topology(ref)
    with pytest.raises(ValueError):
        topo.make_topology("mesh", 4)


# --------------------------------------------------------------------------- #
# Partitioning
# --------------------------------------------------------------------------- #


def _partition(pp):
    return (pp.kernel, pp.axis, pp.n_chips, pp.out_mode, pp.out_axis,
            pp.base.signature(),
            [(s.chip, s.program.signature(), sorted(
                (k, tuple((sl.start, sl.stop) for sl in v))
                for k, v in s.slices.items())) for s in pp.shards],
            [dataclasses.astuple(c) for c in pp.collectives])


@pytest.mark.parametrize("size,n", [(8, 4), (10, 4), (9, 6), (5, 5)])
def test_split_extent_matches_jax_package(size, n):
    assert part.split_extent(size, n) == jax_part.split_extent(size, n)


def test_split_extent_rejects_more_shards_than_rows():
    with pytest.raises(ValueError):
        part.split_extent(3, 4)


GEMM_PARTITIONS = [(64, 48, 32, a, 4) for a in "mnk"] + \
    [(100, 52, 37, a, 3) for a in "mnk"] + [(64, 48, 32, "m", 1)]


@pytest.mark.parametrize("m,n,k,axis,chips", GEMM_PARTITIONS)
def test_gemm_partition_matches_jax_package(m, n, k, axis, chips):
    port, ref = both(lambda part, **_: part.partition_gemm(m, n, k, axis,
                                                           chips))
    assert _partition(port) == _partition(ref)
    assert verify_partition(port) == []


@pytest.mark.parametrize("batch,hidden,chips", [(8, 16, 2), (9, 24, 3)])
def test_gru_partition_matches_jax_package(batch, hidden, chips):
    port, ref = both(lambda part, **_: part.partition_gru(
        batch, hidden, n_chips=chips))
    assert _partition(port) == _partition(ref)
    assert port.collectives == []


def test_partition_rejects_unknown_axes():
    with pytest.raises(ValueError):
        part.partition_gemm(64, 48, 32, "batch", 4)
    with pytest.raises(ValueError):
        part.partition_gru(8, 16, axis="m", n_chips=2)


REPLAYS = [(96, 64, 80, a, 4) for a in "mnk"] + \
    [(100, 52, 37, a, 3) for a in "mnk"]


@pytest.mark.parametrize("m,n,k,axis,chips", REPLAYS)
def test_gemm_replay_bitexact(m, n, k, axis, chips):
    chip = topo.Topology.chip_graph()
    rep = part.replay_bitexact(part.partition_gemm(m, n, k, axis, chips), chip)
    ref = jax_part.replay_bitexact(
        jax_part.partition_gemm(m, n, k, axis, chips),
        jax_topo.Topology.chip_graph())
    assert rep.exact and ref.exact


@pytest.mark.parametrize("batch,hidden,chips", [(8, 16, 2), (9, 24, 3)])
def test_gru_replay_bitexact(batch, hidden, chips):
    pp = part.partition_gru(batch, hidden, n_chips=chips)
    assert part.replay_bitexact(pp, topo.Topology.chip_graph()).exact


def test_replay_bitexact_with_tuned_tiles():
    cfg = {"tile_i": 128, "tile_j": 128, "tile_k": 128,
           "unroll": "red_major"}
    pp = part.partition_gemm(96, 64, 80, "k", 2)
    assert part.replay_bitexact(pp, topo.Topology.chip_graph(),
                                ParamApproach(cfg)).exact


# --------------------------------------------------------------------------- #
# Collective lowering and closed-form costs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("p", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("alg", ["ring", "bidir"])
@pytest.mark.parametrize("kind", ["lower_all_gather", "lower_reduce_scatter",
                                  "lower_all_reduce"])
def test_collective_steps_match_jax_package(p, alg, kind):
    chunks = [1000 + 7 * i for i in range(p)]
    port, ref = both(lambda coll, **_: getattr(coll, kind)(p, chunks, alg))
    assert [dataclasses.astuple(s) for s in port] == \
        [dataclasses.astuple(s) for s in ref]
    assert coll.ALGORITHMS == jax_coll.ALGORITHMS


@pytest.mark.parametrize("p", [1, 2, 4, 7])
@pytest.mark.parametrize("alg", ["ring", "bidir"])
def test_closed_form_costs_match_jax_package(p, alg):
    nb, bw = 4 << 20, 100e9
    for fn in ("all_gather_time", "reduce_scatter_time", "all_reduce_time"):
        port, ref = both(lambda coll, **_: getattr(coll, fn)(
            p, nb, bw, algorithm=alg))
        assert port == ref, fn


def test_closed_form_cost_relations():
    p, nb, bw = 4, 4 << 20, 100e9
    assert coll.all_gather_time(p, nb, bw, algorithm="bidir") < \
        coll.all_gather_time(p, nb, bw, algorithm="ring")
    assert coll.all_reduce_time(p, nb, bw) == pytest.approx(
        coll.reduce_scatter_time(p, nb, bw) + coll.all_gather_time(p, nb, bw))


# --------------------------------------------------------------------------- #
# EventSim and the simulator
# --------------------------------------------------------------------------- #


def test_eventsim_matches_jax_package():
    def run(sim, **_):
        s = sim.EventSim()
        s.add("a", resource="r", duration=2.0)
        s.add("b", resource="r", duration=3.0)
        s.add("c", resource="q", duration=1.0, deps=["a"])
        s.add("d", duration=0.0, deps=["b", "c"])
        return s.run()
    port, ref = both(run)
    assert port == ref == {"a": (0.0, 2.0), "b": (2.0, 5.0), "c": (2.0, 3.0),
                           "d": (5.0, 5.0)}


def test_eventsim_rejects_unknown_deps_and_duplicates():
    s = sim.EventSim()
    s.add("a")
    with pytest.raises(ValueError):
        s.add("a")
    with pytest.raises(ValueError):
        s.add("b", deps=["nope"])


SIMULATIONS = [
    ("gemm", (1024, 512, 512), a, "ring", ("ring", 2), False)
    for a in "mnk"] + [
    ("gemm", (5124, 700, 2048), a, alg, ("ring", 4), False)
    for a in "mnk" for alg in ("ring", "bidir")] + [
    ("gemm", (1024, 512, 512), "k", "ring", ("host_tree", 2), False),
    ("gemm", (1024, 512, 512), "m", "ring", ("ring", 2), True),
    ("gemm", (1024, 512, 512), "k", "bidir", ("ring", 2), True),
    ("gemm", (512, 256, 256), "n", "bidir", ("torus", 2, 2), False),
    ("gru", (32, 256), "batch", "ring", ("ring", 4), False),
]


@pytest.mark.parametrize("kernel,shape,axis,alg,fabric,repl", SIMULATIONS)
def test_simulate_partition_matches_jax_package(kernel, shape, axis, alg,
                                                fabric, repl):
    def run(topo, part, sim, **_):
        t = getattr(topo, fabric[0])(*fabric[1:])
        pp = part.partition(kernel, shape, axis, t.n_chips)
        if repl:
            pp = sim.replicate_output(pp)
        chip = topo.Topology.chip_graph()
        res = sim.simulate_partition(pp, t, None, alg, chip)
        return (dataclasses.astuple(res), res.comm_bound,
                sim.single_chip_makespan(pp, chip),
                [dataclasses.astuple(c) for c in pp.collectives])
    port, ref = both(run)
    assert port == ref


def test_simulate_rejects_chip_count_mismatch():
    pp = part.partition_gemm(64, 64, 64, "k", 2)
    with pytest.raises(ValueError):
        sim.simulate_partition(pp, topo.ring(4),
                               chip_graph=topo.Topology.chip_graph())


def test_acceptance_shape_beats_one_chip_on_two_axes():
    chip = topo.Topology.chip_graph()
    one = sim.single_chip_makespan(
        part.partition_gemm(5124, 700, 2048, "m", 1), chip)
    wins = sum(
        min(sim.simulate_partition(part.partition_gemm(5124, 700, 2048, a, 4),
                                   topo.ring(4), None, alg, chip).makespan
            for alg in coll.ALGORITHMS) < one
        for a in "mnk")
    assert wins >= 2


@pytest.mark.parametrize("axis,alg", [("k", "ring"), ("n", "bidir")])
def test_verify_fabric_is_clean(axis, alg):
    pp = part.partition_gemm(256, 128, 128, axis, 2)
    assert verify_fabric(pp, topo.ring(2), algorithm=alg) == []


# --------------------------------------------------------------------------- #
# Search integration
# --------------------------------------------------------------------------- #


def test_fabric_space_matches_jax_package():
    space, ref = SearchSpace.for_fabric("gemm"), JaxSearchSpace.for_fabric("gemm")
    assert [(a.name, a.choices) for a in space.axes] == \
        [(a.name, a.choices) for a in ref.axes]
    assert space.baseline() == ref.baseline()
    assert space.baseline()["part_axis"] == "m"
    assert "part_axis" not in [a.name for a in SearchSpace().axes]


FABRIC_CONFIGS = [{}, {"part_axis": "k", "collective": "bidir"},
                  {"part_axis": "n", "tile_i": 128, "tile_k": 256},
                  {"part_axis": "nope"}]


@pytest.mark.parametrize("delta", FABRIC_CONFIGS)
def test_fabric_evaluator_matches_jax_package(delta):
    def run(topo, sim, **_):
        ev = sim.FabricEvaluator("gemm", (512, 256, 256), topo.ring(2))
        return ev({**SearchSpace.for_fabric("gemm").baseline(), **delta})
    port, ref = both(run)
    assert port == ref
    if delta.get("part_axis") == "nope":
        assert port == float("inf")


def test_joint_fabric_search_matches_jax_package():
    def run(topo, sim, **_):
        ev = sim.FabricEvaluator("gemm", (512, 256, 256), topo.ring(2))
        out = STRATEGIES["hillclimb"](SearchSpace.for_fabric("gemm"), ev,
                                      trials=8, seed=0)
        return out.best_cost, out.baseline_cost, out.best_config
    port, ref = both(run)
    assert port == ref
    assert port[0] <= port[1]


def test_tune_fabric_case_matches_jax_package():
    rep = tune_fabric_case(512, 256, 256, topo.ring(2), "random", trials=4,
                           seed=0)
    ref = jax_tune_fabric_case(512, 256, 256, jax_topo.ring(2), "random",
                               trials=4, seed=0)
    assert rep.ok and rep.validation.exact
    assert (rep.greedy_cost, rep.tuned_cost, rep.config, rep.name) == \
        (ref.greedy_cost, ref.tuned_cost, ref.config, ref.name)
    rec = fabric_record_for(rep, topo.ring(2), "random")
    assert rec.backend == "fabric" and rec.meta["chips"] == 2


def test_tune_cli_fabric_suite(tmp_path, capsys):
    from repro_torch.search.tune import main
    rc = main(["--suite", "fabric", "--chips", "2", "--limit", "1",
               "--trials", "2", "--cache", str(tmp_path / "t.json")])
    assert rc == 0
    assert "[ok] fabric_gemm_5124x700x2048_ring2" in capsys.readouterr().out
    assert main(["--suite", "fabric", "--backend", "measure"]) == 2


# --------------------------------------------------------------------------- #
# compile_fabric
# --------------------------------------------------------------------------- #


def _without_version(d: dict) -> dict:
    return {**d, "key": d["key"].rsplit("|", 1)[0]}


@pytest.mark.parametrize("kernel,shape,axis,alg,repl", [
    ("gemm", (512, 256, 256), "m", "ring", False),
    ("gemm", (512, 256, 256), "k", "bidir", False),
    ("gemm", (512, 256, 256), "k", "ring", True),
    ("gru", (8, 64), "batch", "ring", False)])
def test_compile_fabric_matches_jax_package(kernel, shape, axis, alg, repl):
    art = compile_fabric(kernel, shape, topo.ring(2), axis, algorithm=alg,
                         replicate_out=repl, use_cache=False)
    ref = jax_compile_fabric(kernel, shape, jax_topo.ring(2), axis,
                             algorithm=alg, replicate_out=repl,
                             use_cache=False)
    assert _without_version(art.to_dict()) == _without_version(ref.to_dict())
    assert art.fabric["chips"] == 2


def test_compile_fabric_rebuilds_the_chip_schedule_from_a_hit():
    from repro_torch.compile.driver import recompile_schedule
    art = compile_fabric("gemm", (512, 256, 256), topo.ring(2), "k",
                         use_cache=False)
    hit = compile_fabric("gemm", (512, 256, 256), topo.ring(2), "k")
    hit = compile_fabric("gemm", (512, 256, 256), topo.ring(2), "k")
    assert hit.from_cache and hit.schedule is None
    recompile_schedule(hit)
    assert hit.schedule.makespan == art.fabric["per_chip_cost"]


def test_simulate_cli_matches_jax_package(tmp_path, capsys):
    import json
    args = ["--shape", "256x128x96", "--chips", "2", "--proxy-cap", "32"]
    assert sim.main(args + ["--json", str(tmp_path / "port.json")]) == 0
    assert jax_sim.main(args + ["--json", str(tmp_path / "jax.json")]) == 0
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert port == ref
    assert [r["oracle_exact"] for r in port["rows"]] == [True] * 3
