"""The port's dry run (``repro_torch.launch.dryrun``, ``op_flops``,
``hlo_analysis``) against the JAX package's, on the CPU.

Both dry runs fix per-process state (JAX's ``XLA_FLAGS`` device count, the
port's ``fake`` process group), so each runs in a process of its own, on
olmo-1b scaled to ``SCALED`` (the mesh divides every dimension): train_4k
on the single and multi meshes and decode_32k on the single one.  Held:
one rank's parameter and moment bytes (exactly, against JAX's shard
shapes), argument bytes (1%), the traced FLOPs times the ranks against
JAX's ``hlo_flops`` times ``chips`` (1%), ``model_flops`` (exactly),
collective bytes above 0 on both sides (their ratio is printed: XLA's
partitioner and DTensor choose different collectives), the skipped
records, and ``roofline_terms`` on both targets.  Then every parameter,
moment, batch and cache leaf of every full config, placed on both
production meshes of a ``fake`` group, has the local shape its spec
implies; and the op counter's unit cases.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from repro.launch import hlo_analysis as jax_hlo_analysis
from repro_torch.configs import ARCHS
from repro_torch.launch import hlo_analysis
from repro_torch.launch.op_flops import OpCounter, dot_flops

ROOT = Path(__file__).resolve().parent.parent
SCALED = dict(n_layers=2, d_model=1024, n_heads=16, n_kv_heads=16,
              d_ff=4096, vocab_size=16384)
CELLS = [("olmo-1b", "train_4k", "single"), ("olmo-1b", "train_4k", "multi"),
         ("olmo-1b", "decode_32k", "single")]
SKIPPED = ("olmo-1b", "long_500k", "single")

JAX_RUN = """
import json, math, sys, time
from repro.launch import dryrun
import jax
from repro.dist.sharding import param_shardings
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import eval_shape_params
from repro.configs import get_config
over, cells, skipped = json.loads(sys.argv[1])
out = {}
for arch, shape, mesh in cells:
    t0 = time.time()
    compiled, lowered, meta = dryrun.lower_cell(arch, shape, mesh == "multi",
                                                over)
    rec = dryrun.analyse(compiled, lowered, meta, time.time() - t0)
    m = make_production_mesh(multi_pod=mesh == "multi")
    cfg = get_config(arch).scaled(**over)
    _, params = eval_shape_params(cfg)
    sh = param_shardings(params, m, cfg)
    rec["param_bytes"] = sum(
        math.prod(s.shard_shape(p.shape)) * p.dtype.itemsize
        for p, s in zip(jax.tree.leaves(params), jax.tree.leaves(sh)))
    out["/".join((arch, shape, mesh))] = rec
out["skipped"] = dryrun.run_cell(*skipped, None)
print(json.dumps(out, default=str))
"""

PORT_RUN = """
import json, sys
import torch
from repro_torch.launch import dryrun
over, cells, skipped = json.loads(sys.argv[1])
out = {"/".join(c): dryrun.run_cell(*c, None, overrides=over) for c in cells}
out["skipped"] = dryrun.run_cell(*skipped, None)
# an all-gather of a known shard on the fake group, under the counter
import torch.distributed as dist
from torch.distributed._functional_collectives import all_gather_tensor
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.op_flops import OpCounter
with FakeTensorMode():
    shard = torch.empty(3, 5, dtype=torch.bfloat16)
    counter = OpCounter()
    with counter:
        all_gather_tensor(shard, 0, dist.group.WORLD)
out["all_gather"] = counter.collectives.as_dict()
print(json.dumps(out, default=str))
"""


def run(script: str, extra_env: dict) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra_env)
    res = subprocess.run(
        [sys.executable, "-c", script,
         json.dumps([SCALED, CELLS, list(SKIPPED)])],
        capture_output=True, text=True, timeout=900, cwd=ROOT, env=env,
        check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def records():
    jax_recs = run(JAX_RUN, {"JAX_PLATFORMS": "cpu"})
    port_recs = run(PORT_RUN, {})
    return jax_recs, port_recs


@pytest.mark.parametrize("cell", ["/".join(c) for c in CELLS])
def test_dry_run_cells_agree_with_the_jax_packages(records, cell):
    jax_rec, rec = records[0][cell], records[1][cell]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == jax_rec["chips"]
    for key in ("arch", "shape", "kind", "chips"):
        assert rec[key] == jax_rec[key], key
    mem, jmem = rec["memory"], jax_rec["memory"]
    assert mem["param_bytes"] == jax_rec["param_bytes"]
    if rec["kind"] == "train":      # f32 moments beside f32 parameters
        assert mem["opt_state_bytes"] == 2 * jax_rec["param_bytes"] + 4
    np.testing.assert_allclose(mem["argument_bytes"],
                               jmem["argument_bytes"], rtol=1e-2)
    np.testing.assert_allclose(rec["hlo_flops"] * rec["chips"],
                               jax_rec["hlo_flops"] * jax_rec["chips"],
                               rtol=1e-2)
    assert rec["model_flops"] == jax_rec["model_flops"]
    coll, jcoll = (r["collectives"]["total_bytes"] for r in (rec, jax_rec))
    assert coll > 0 and jcoll > 0
    print(f"{cell}: collective bytes port/JAX {coll / jcoll:.3f}")
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert rec["roofline"] == hlo_analysis.roofline_terms(
        rec["hlo_flops"] * rec["chips"], rec["hlo_bytes"] * rec["chips"],
        coll * rec["chips"], rec["chips"], target="gpu_sm")


def test_skipped_records_are_the_jax_packages(records):
    assert records[1]["skipped"] == records[0]["skipped"]
    assert records[1]["skipped"]["status"] == "skipped"


@pytest.mark.parametrize("target", ["tpu_v5e", "gpu_sm"])
@pytest.mark.parametrize("terms", [(1e18, 3e15, 2e12, 256),
                                   (4.2e14, 9e16, 0.0, 512),
                                   (0.0, 0.0, 5e13, 256)])
def test_roofline_terms_equal_the_jax_packages(terms, target):
    assert hlo_analysis.roofline_terms(*terms, target=target) == \
        jax_hlo_analysis.roofline_terms(*terms, target=target)
    assert hlo_analysis.TARGET_ROOFLINES == jax_hlo_analysis.TARGET_ROOFLINES
    stats = hlo_analysis.CollectiveStats({"all-gather": 8}, {"all-gather": 1})
    jstats = jax_hlo_analysis.CollectiveStats({"all-gather": 8},
                                              {"all-gather": 1})
    assert stats.as_dict() == jstats.as_dict()


def test_op_counter_counts_a_matmul_and_the_bytes_it_moves():
    a, b, bias = torch.ones(6, 7), torch.ones(7, 5), torch.zeros(5)
    a3, b3 = torch.ones(3, 6, 7), torch.ones(3, 7, 5)
    counter = OpCounter()
    with counter:
        c = a @ b
        torch.addmm(bias, a, b)
        torch.bmm(a3, b3)
        c.view(5, 6)                    # a view moves nothing
    assert counter.flops == 2 * 6 * 5 * 7 * (1 + 1 + 3)
    f32 = 4
    assert counter.bytes_accessed == f32 * (
        (6 * 7 + 7 * 5 + 6 * 5) + (5 + 6 * 7 + 7 * 5 + 6 * 5)
        + 3 * (6 * 7 + 7 * 5 + 6 * 5))
    assert dot_flops(torch.ops.aten.mm.default, (a, b), c) == 2 * 6 * 5 * 7


def test_op_counter_counts_an_all_gather_of_a_known_shard(records):
    assert records[1]["all_gather"] == {
        "total_bytes": 3 * 5 * 2, "total_count": 1,
        "bytes_by_kind": {"all-gather": 30},
        "count_by_kind": {"all-gather": 1}}


# --------------------------------------------------------------------------- #
# every leaf of every full config on a fake group of 512 ranks
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def placement(tmp_path_factory):
    out = tmp_path_factory.mktemp("placement")
    subprocess.run([sys.executable, worker.__file__, "placement", str(out)],
                   check=True, timeout=900, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return torch.load(out / "placement.pt", weights_only=False)


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_of_every_full_config_has_its_specs_local_shape(
        placement, arch, mesh):
    res = placement[f"{arch}/{mesh}"]
    assert res["bad"] == []
    counts = res["counts"]
    assert counts["param"] == counts["mu"] == counts["nu"] > 100
    assert counts["batch"] >= 3 and counts["cache"] >= 2
