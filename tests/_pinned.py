"""Pin both packages to one compile target (``test_torch_servesim.py``,
``test_torch_mutate.py``, ``test_torch_cli.py``).

``ServingPool``, the mutation harness's bundles and the verify CLI compile
with no target, and the two packages' defaults differ (``tpu_v5e(1)`` in
JAX, ``gpu_sm(8)`` in the port).  ``pin`` makes both packages'
``compile_graph``, ``compile_gemm`` and ``search.tune.make_graph`` default
to one target, and rebuilds the mutation bundles under it (each package's
memo of them is put back when the monkeypatch is undone).
"""
from __future__ import annotations

import functools

import repro.compile.driver as jax_driver
import repro.graph.compile as jax_graph_compile
import repro.search.tune as jax_tune
import repro.verify.mutate as jax_mutate
import repro_torch.compile.driver as port_driver
import repro_torch.graph.compile as port_graph_compile
import repro_torch.search.tune as port_tune
import repro_torch.verify.mutate as port_mutate
from repro.core.sysgraph import gpu_sm as jax_gpu_sm
from repro.core.sysgraph import tpu_v5e as jax_tpu_v5e
from repro_torch.core.sysgraph import gpu_sm, tpu_v5e

#: target -> (the port's system graph, the JAX package's)
TARGETS = {"tpu_v5e": (lambda: tpu_v5e(1), lambda: jax_tpu_v5e(1)),
           "gpu_sm": (lambda: gpu_sm(8), lambda: jax_gpu_sm(8))}


def _graph_default(orig, make, g, graph=None, *args, **kwargs):
    return orig(g, make() if graph is None else graph, *args, **kwargs)


def _gemm_default(orig, make, *args, graph=None, **kwargs):
    return orig(*args, graph=make() if graph is None else graph, **kwargs)


def pin(mp, target: str) -> None:
    """Pin both packages to ``target`` through the ``pytest.MonkeyPatch``
    ``mp``."""
    port_make, jax_make = TARGETS[target]
    for driver, graph_compile, tune, mutate, make in (
            (port_driver, port_graph_compile, port_tune, port_mutate,
             port_make),
            (jax_driver, jax_graph_compile, jax_tune, jax_mutate, jax_make)):
        mp.setattr(driver, "compile_gemm", functools.partial(
            _gemm_default, driver.compile_gemm, make))
        mp.setattr(graph_compile, "compile_graph", functools.partial(
            _graph_default, graph_compile.compile_graph, make))
        mp.setattr(tune, "make_graph", lambda name, make=make: make())
        mp.setattr(mutate, "_BASE", {})
