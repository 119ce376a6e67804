"""The frozen reference against a float64 NumPy GRU, and its controls."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench import reference


def _numpy_gru(xs, h0, p):
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))
    h = h0
    for x in xs:
        r = sig(x @ p["Wr"] + h @ p["Ur"] + p["br"])
        z = sig(x @ p["Wz"] + h @ p["Uz"] + p["bz"])
        n = np.tanh(x @ p["Wn"] + p["bnx"] + r * (h @ p["Un"] + p["bnh"]))
        h = (1 - z) * n + z * h
    return h


def _params(rng, E, H):
    shapes = {"W": (E, H), "U": (H, H), "b": (H,)}
    return {n: rng.uniform(-0.3, 0.3, shapes[n[0]])
            for n in reference.GRU_NAMES}


def test_gru_reference_matches_float64_numpy():
    rng = np.random.default_rng(0)
    T, B, E, H = 7, 3, 5, 6
    p = _params(rng, E, H)
    xs, h0 = rng.uniform(-1, 1, (T, B, E)), rng.uniform(-1, 1, (B, H))
    got = reference.gru_seq(torch.from_numpy(xs), torch.from_numpy(h0),
                            reference.GRUWeights({k: torch.from_numpy(v)
                                                  for k, v in p.items()}),
                            torch.float64)
    np.testing.assert_allclose(got.numpy(), _numpy_gru(xs, h0, p),
                               rtol=1e-12, atol=1e-12)


def test_gru_reference_rounds_h_every_step():
    rng = np.random.default_rng(1)
    p = {k: torch.from_numpy(v).bfloat16() for k, v in _params(rng, 4, 4).items()}
    xs = torch.from_numpy(rng.uniform(-1, 1, (3, 2, 4))).bfloat16()
    h0 = torch.from_numpy(rng.uniform(-1, 1, (2, 4))).bfloat16()
    wts = reference.GRUWeights(p)
    h = h0
    for x in xs:
        h = reference.gru_step(x, h, wts, torch.bfloat16)
    assert torch.equal(h, reference.gru_seq(xs, h0, wts, torch.bfloat16))
    assert h.dtype == torch.bfloat16


def test_lower_precisions():
    t = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -9, -3.0, 0.1])
    assert torch.equal(reference.lower(t), t.double())
    tf = reference.lower(t, "tf32")
    assert tf[0] == 1.0 and tf[1] == 1.0 + 2.0 ** -9 and tf[2] == -3.0
    assert abs(float(tf[3]) - 0.1) <= 0.1 * 2.0 ** -11
    f8 = reference.lower(t, "fp8")
    assert float((f8 - t.double()).abs().max()) <= 3.0 * 2.0 ** -4


def test_rel_rms():
    a = torch.ones(4, 3)
    assert reference.rel_rms(a, a) == 0.0
    b = a.clone()
    b[0, 0] = 2.0
    assert reference.rel_rms(b, a) == pytest.approx(math.sqrt(1 / 12))
    b[0, 0] = float("nan")
    assert reference.rel_rms(b, a) == math.inf
    assert reference.rel_rms(a[:2], a) == math.inf
