"""The port's mutation harness (``repro_torch.verify.mutate``) against the
JAX package's, on the CPU.

The registry is the JAX package's: the same 44 corruption classes, each
with its expected rule and bundle kind.  On the port's own target
(``gpu_sm(8)``, where the port's bundles compile) the unmutated bundles
verify clean and every class is caught by its expected rule.  Pinned to
one target at a time (both packages' ``compile_gemm`` and ``compile_graph``
defaulting to it while the bundles are built), the port's baseline and the
rules each mutation fires equal the JAX package's.
"""
from __future__ import annotations

import pytest

import repro.verify.mutate as jax_mutate
import repro_torch.verify.mutate as port_mutate
from _pinned import TARGETS, pin
from repro_torch.verify.mutate import (MUTATIONS, baseline_report,
                                       run_mutation)


@pytest.fixture(scope="module", params=list(TARGETS))
def pinned_bundles(request):
    """Every bundle of both packages built with ``compile_gemm`` and
    ``compile_graph`` defaulting to the target: (target, port bundles,
    JAX bundles, port baseline, JAX baseline)."""
    with pytest.MonkeyPatch.context() as mp:
        pin(mp, request.param)
        port_report = baseline_report()
        jax_report = jax_mutate.baseline_report()
        bases = dict(port_mutate._BASE), dict(jax_mutate._BASE)
    return (request.param, *bases, port_report, jax_report)


def test_registry_equals_the_jax_packages():
    assert [(n, rule, kind) for n, (rule, kind, _) in MUTATIONS.items()] \
        == [(n, rule, kind)
            for n, (rule, kind, _) in jax_mutate.MUTATIONS.items()]
    kinds = [kind for _, kind, _ in MUTATIONS.values()]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "gemm": 23, "graph": 7, "fabric": 6, "serve": 4, "incremental": 2,
        "gpu": 2}
    layers = {rule.split(".", 1)[0] for rule, _, _ in MUTATIONS.values()}
    assert layers == {"prg", "sel", "sch", "fab", "gra", "srv", "art"}


def test_mutation_baseline_is_clean():
    report = baseline_report()
    assert report.ok and report.diagnostics == [], report.render()


def test_pinned_baseline_equals_the_jax_packages(pinned_bundles):
    _, _, _, port_report, jax_report = pinned_bundles
    assert port_report.ok and port_report.diagnostics == [], \
        port_report.render()
    assert port_report.to_dict() == jax_report.to_dict()


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_is_caught(name):
    res = run_mutation(name)
    assert res.caught, str(res)
    # one corruption ~ one primary finding: the expected rule fires, and the
    # report stays small (no cascade of unrelated diagnostics)
    assert res.expected in res.rules
    assert len(set(res.rules)) <= 3, str(res)


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_fires_the_jax_packages_rules(pinned_bundles, name,
                                               monkeypatch):
    target, port_base, jax_base, _, _ = pinned_bundles
    monkeypatch.setattr(port_mutate, "_BASE", port_base)
    monkeypatch.setattr(jax_mutate, "_BASE", jax_base)
    res, ref = run_mutation(name), jax_mutate.run_mutation(name)
    assert res.caught, f"{target}: {res}"
    assert set(res.rules) == set(ref.rules), f"{target}: {res} vs {ref}"
    assert str(res) == str(ref)
