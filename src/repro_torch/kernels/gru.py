"""K3 and K4: the fused GRU cell and the GRU sequence (paper Figure 4).

``gru_cell`` launches the hand-written CUDA kernel in ``csrc/gru.cu``: all
three gates and the state update of one step in one kernel, over a grid of
(batch tile, hidden tile) blocks.  ``gru_seq`` runs it over T steps with the
weights on the device for all of them and two preallocated hidden-state
buffers used in turn, so nothing is allocated per step.  On CPU tensors both
run the plain versions (``ref.gru_cell_ref`` / ``ref.gru_seq_ref``).

``tile=(BB, BH)`` is one block's (batch, hidden) tile, normally chosen by
``ops.gru_tile`` from the compiler's GRU plan.  ``FusedGRU`` holds the ten
parameters (``PARAM_NAMES``) as buffers of an ``nn.Module``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import nn

from .cuda import check, library, resolve_device, stream_handle
from .ref import gru_cell_ref, gru_seq_ref

PARAM_NAMES = ("Wr", "Ur", "Wz", "Uz", "Wn", "Un", "br", "bz", "bnx", "bnh")
#: tile dims the CUDA library is built for
TILE_B = (16, 32)
TILE_H = (16, 32)
DEFAULT_TILE = (32, 16)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = library("gru").repro_gru_cell
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 13
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_tile(tile) -> tuple[int, int]:
    bb, bh = (int(t) for t in tile)
    if bb not in TILE_B or bh not in TILE_H:
        raise ValueError(f"gru tile {tuple(tile)} not built: BB in {TILE_B}, "
                         f"BH in {TILE_H}")
    return bb, bh


def _check_operands(x: torch.Tensor, h: torch.Tensor, params: dict) -> None:
    """Shapes of one step: x (B, E), h (B, H), W* (E, H), U* (H, H), b* (H,);
    on a CUDA device: one device, f32, contiguous."""
    if x.dim() != 2 or h.dim() != 2 or x.shape[0] != h.shape[0]:
        raise ValueError(f"gru x {tuple(x.shape)}, h {tuple(h.shape)}")
    E, H = x.shape[1], h.shape[1]
    want = {"W": (E, H), "U": (H, H), "b": (H,)}
    for name in PARAM_NAMES:
        if tuple(params[name].shape) != want[name[0]]:
            raise ValueError(f"gru {name} {tuple(params[name].shape)}, "
                             f"want {want[name[0]]}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"gru runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("h", h), *((n, params[n]) for n in PARAM_NAMES)):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"gru {name}: need contiguous float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if min(x.shape[0], E, H) == 0:
        raise ValueError("gru with an empty dimension")


def _launch_cell(bb: int, bh: int, x: torch.Tensor, h: torch.Tensor,
                 wptrs: tuple, out: torch.Tensor, stream: int) -> None:
    B, E = x.shape
    H = h.shape[1]
    check(_kernel()(bb, bh, x.data_ptr(), h.data_ptr(), *wptrs,
                    out.data_ptr(), B, E, H, stream), "gru_cell")
    gru_cell.launches += 1


def gru_cell(x: torch.Tensor, h: torch.Tensor, params: dict,
             tile: tuple[int, int] = DEFAULT_TILE,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """One fused GRU step: x (B, E), h (B, H) -> h' (B, H).  ``out``, when
    given, receives h' and must not be ``h``'s storage."""
    bb, bh = _check_tile(tile)
    _check_operands(x, h, params)
    if x.device.type == "cpu":
        return gru_cell_ref(x, h, params)
    if out is None:
        out = torch.empty_like(h)
    elif out.shape != h.shape or out.dtype != h.dtype \
            or out.device != h.device or not out.is_contiguous():
        raise ValueError("gru_cell out must be a contiguous tensor like h")
    if out.data_ptr() == h.data_ptr():
        raise ValueError("gru_cell out must not alias h")
    wptrs = tuple(params[n].data_ptr() for n in PARAM_NAMES)
    _launch_cell(bb, bh, x, h, wptrs, out, stream_handle(x.device))
    return out


gru_cell.launches = 0


def gru_seq(xs: torch.Tensor, h0: torch.Tensor, params: dict,
            tile: tuple[int, int] = DEFAULT_TILE) -> torch.Tensor:
    """GRU over xs [T, B, E] from h0 [B, H]; returns the final hidden state.
    The weights stay on the device across the T launches of ``gru_cell``."""
    bb, bh = _check_tile(tile)
    if xs.dim() != 3 or xs.shape[0] == 0:
        raise ValueError(f"gru_seq xs {tuple(xs.shape)}: want [T>0, B, E]")
    _check_operands(xs[0], h0, params)
    if xs.device.type == "cpu":
        return gru_seq_ref(xs, h0, params)
    if not xs.is_contiguous():
        raise ValueError("gru_seq needs a contiguous xs")
    bufs = (torch.empty_like(h0), torch.empty_like(h0))
    wptrs = tuple(params[n].data_ptr() for n in PARAM_NAMES)
    stream = stream_handle(xs.device)
    h = h0
    for t in range(xs.shape[0]):
        _launch_cell(bb, bh, xs[t], h, wptrs, bufs[t % 2], stream)
        h = bufs[t % 2]
    gru_seq.launches += 1
    return h


gru_seq.launches = 0


class FusedGRU(nn.Module):
    """The GRU's ten parameters as buffers; ``forward(xs, h0)`` runs the
    sequence through the compiler's plan (``ops.scheduled_gru``)."""

    def __init__(self, inp: int, hidden: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        shapes = {"W": (inp, hidden), "U": (hidden, hidden), "b": (hidden,)}
        for name in PARAM_NAMES:
            self.register_buffer(name, torch.zeros(shapes[name[0]],
                                                   device=dev, dtype=dtype))

    @classmethod
    def from_numpy(cls, params: dict[str, np.ndarray], device=None,
                   dtype: torch.dtype = torch.float32) -> "FusedGRU":
        """Carry the JAX package's GRU parameters (numpy arrays keyed by
        ``PARAM_NAMES``) over."""
        inp, hidden = np.shape(params["Wr"])
        gru = cls(inp, hidden, device=device, dtype=dtype)
        for name in PARAM_NAMES:
            src = torch.from_numpy(np.ascontiguousarray(params[name]))
            if tuple(src.shape) != tuple(getattr(gru, name).shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)}, want "
                                 f"{tuple(getattr(gru, name).shape)}")
            getattr(gru, name).copy_(src)
        return gru

    def params(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def forward(self, xs: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
        from .ops import scheduled_gru
        return scheduled_gru(xs, h0, self)
