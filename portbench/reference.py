"""The plain references that decide ``correct``, and their controls.

Plain PyTorch in float64, from the inputs the benchmark made: nothing of
the program is imported or read here, neither its kernels nor its plain
versions nor anything it derived from the inputs (packed weights, tiles).

``precision`` says in which precision a function takes its operands:

* ``"config"`` — as the configuration states them (the values as made);
* ``"tf32"`` — rounded to TF32's 10 mantissa bits: the control of an f32
  configuration, the step below IEEE f32 with TF32 off;
* ``"fp8"`` — rounded to fp8 e4m3 with one scale a tensor: the control of a
  bf16 configuration.

The arithmetic is float64 throughout; each result is rounded once to the
dtype the configuration stores it in.  A GRU's hidden state is rounded to
that dtype after every step, as the configuration states.
"""
from __future__ import annotations

import math

import torch

PRECISIONS = ("config", "tf32", "fp8")
#: the largest finite fp8 e4m3 value
FP8_MAX = 448.0


def strict() -> None:
    """Keep torch's own float32 products IEEE: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def lower(t: torch.Tensor, precision: str = "config") -> torch.Tensor:
    """``t``'s values in ``precision`` (see the module), as float64."""
    if precision == "config":
        return t.double()
    if precision == "tf32":
        bits = t.float().contiguous().view(torch.int32)
        bits = (bits + 0x1000) & -0x2000       # round to nearest, 10 bits
        return bits.view(torch.float32).double()
    if precision == "fp8":
        t32 = t.float()
        scale = max(float(t32.abs().amax()), 1e-30) / FP8_MAX
        return ((t32 / scale).to(torch.float8_e4m3fn).float() * scale).double()
    raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")


def gemm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype,
         precision: str = "config") -> torch.Tensor:
    """C = A @ B, rounded once to ``out_dtype``."""
    strict()
    return (lower(a, precision) @ lower(b, precision)).to(out_dtype)


GRU_NAMES = ("Wr", "Ur", "Wz", "Uz", "Wn", "Un", "br", "bz", "bnx", "bnh")


class GRUWeights:
    """A GRU's ten raw weights (x W + h U convention: W (E, H), U (H, H),
    biases (H,)) in ``precision``, concatenated gate-wise once for all the
    steps the reference runs: [Wr|Wz|Wn], [Ur|Uz|Un]."""

    def __init__(self, params: dict, precision: str = "config"):
        self.precision = precision
        self.w = torch.cat([lower(params[n], precision)
                            for n in ("Wr", "Wz", "Wn")], 1)
        self.u = torch.cat([lower(params[n], precision)
                            for n in ("Ur", "Uz", "Un")], 1)
        self.bx = torch.cat([params[n].double() for n in ("br", "bz", "bnx")])
        self.bnh = params["bnh"].double()
        self.hidden = params["Ur"].shape[0]


def gru_step(x: torch.Tensor, h: torch.Tensor, wts: GRUWeights,
             out_dtype: torch.dtype) -> torch.Tensor:
    """One GRU step: r = s(x Wr + h Ur + br), z = s(x Wz + h Uz + bz),
    n = tanh(x Wn + bnx + r (h Un + bnh)), h' = (1 - z) n + z h, rounded to
    ``out_dtype``.  The operands of the products are in ``wts``' precision;
    the blend takes h as it is."""
    strict()
    H = wts.hidden
    gx = lower(x, wts.precision) @ wts.w + wts.bx
    gh = lower(h, wts.precision) @ wts.u
    r = torch.sigmoid(gx[:, :H] + gh[:, :H])
    z = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gx[:, 2 * H:] + r * (gh[:, 2 * H:] + wts.bnh))
    return ((1 - z) * n + z * h.double()).to(out_dtype)


def gru_seq(xs: torch.Tensor, h0: torch.Tensor, wts: GRUWeights,
            out_dtype: torch.dtype) -> torch.Tensor:
    """The final hidden state of a GRU over xs [T, B, E] from h0 [B, H]:
    ``gru_step`` T times, h rounded to ``out_dtype`` after every step."""
    h = h0
    for x in xs:
        h = gru_step(x, h, wts, out_dtype)
    return h


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float64; infinite where ``got`` has
    another shape or a value that is not finite."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    g, w = got.double(), want.double()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    den = float(torch.linalg.vector_norm(w))
    num = float(torch.linalg.vector_norm(g - w))
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)
