"""K3 and K4: the fused GRU cell and the GRU sequence (paper Figure 4).

``gru_cell`` (K3) launches the hand-written CUDA step in ``csrc/gru.cu``:
all three gates and the state update of one step, over a grid of
(hidden tile, reduction slice, batch tile) blocks.  The reduction over E
(x W) and H (h U) is cut into ``gru_split`` slices so that a step fills
the card in whole waves; with more than one slice a second kernel adds the
slices' partial sums in slice order and applies the gate epilogue
(``gru_cell_reduce`` counts it).

``gru_seq`` (K4) hoists the input projection out of the recurrence: K2
(``gemm_bias_act``) computes G = xs [T B, E] @ [Wr|Wz|Wn] + [br|bz|bnx] for
all T steps in one product, and one cooperative CUDA kernel runs the T
steps of h [Ur|Uz|Un], each block keeping its panel of U in shared memory
where it fits (``gru_seq_launch``).  Two launches a sequence of up to 64
batch rows, no K3; a larger batch takes one recurrence launch for each
group of rows (``SeqLaunch.batch``).  The
packed operands ([Wr|Wz|Wn], each block's U panel) are built on every call
from the parameters as they are then (``pack_w``, ``pack_u``): a cached copy
could go stale when a buffer is written in place, and the copies take tens
of microseconds against a sequence of milliseconds.

On CPU tensors both run the plain versions (``ref.gru_cell_ref``,
``ref.gru_seq_hoisted_ref``); on CUDA tensors they launch the kernels or
raise.  ``tile=(BB, BH)`` is one K3 block's (batch, hidden) tile, normally
chosen by ``ops.gru_tile`` from the compiler's GRU plan.  ``FusedGRU``
holds the ten parameters (``PARAM_NAMES``) as buffers of an ``nn.Module``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .cuda import (MAX_SMEM_BYTES, check, library, resolve_device,
                   stream_handle)
from .gemm import H100_SMS, Counter, device_sms, gemm_bias_act
from .ref import gru_cell_ref, gru_seq_hoisted_ref

PARAM_NAMES = ("Wr", "Ur", "Wz", "Uz", "Wn", "Un", "br", "bz", "bnx", "bnh")
#: tile dims the CUDA library is built for
TILE_B = (16, 32)
TILE_H = (16, 32, 64)
DEFAULT_TILE = (32, 16)
#: K3: reduction rows per chunk (``csrc/gru.cu`` kStepKC)
STEP_KC = 32
#: K3's resident blocks a SM where no card is asked (the CPU's plans): an
#: H100 build's 128 registers x 256 threads.  On the card ``device_split``
#: asks the library (``step_blocks_per_sm``)
STEP_BLOCKS_PER_SM = 2
#: K4: threads of a block, rows of h per staged chunk, the ring's depth,
#: batch rows per thread, the most batch rows a launch and k-lanes
SEQ_THREADS = 512
SEQ_KC = 64
SEQ_STAGES = 4
SEQ_RB = 8
SEQ_MAX_B = 64
SEQ_MAX_LANES = SEQ_KC // 4
#: the constants above as ``csrc/gru.cu`` defines them, in the order its
#: ``repro_gru_constants`` writes them; checked when the library is bound
C_CONSTANTS = (STEP_KC, SEQ_THREADS, SEQ_KC, SEQ_STAGES, SEQ_RB, SEQ_MAX_B)

#: K3's second kernel: the split step's reduce
gru_cell_reduce = Counter()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_cost(B: int, E: int, H: int, tiles: int, split: int,
               sms: int = H100_SMS,
               per_sm: int = STEP_BLOCKS_PER_SM) -> float:
    """The modeled time of a K3 step cut into ``split`` slices, relative to
    one that streams the weights at full rate on every SM: the waves of
    ``per_sm`` resident blocks a SM the grid takes, over the
    waves it would take if it divided evenly, times the bytes moved (the
    weights, 12 H (E + H), plus the split's f32 partials written and read
    back, 2 x 16 split B H) over the weights' bytes."""
    slots = per_sm * sms
    blocks = tiles * split
    waves = -(-blocks // slots)
    partials = 32 * split * B * H if split > 1 else 0
    return waves * slots / blocks * (1 + partials / (12 * H * (E + H)))


@functools.lru_cache(maxsize=None)
def gru_split(B: int, E: int, H: int, tile: tuple[int, int],
              sms: int = H100_SMS, per_sm: int = STEP_BLOCKS_PER_SM) -> int:
    """How many slices K3's reduction (ceil(E / STEP_KC) + ceil(H / STEP_KC)
    chunks) is cut into on ``sms`` SMs that each hold ``per_sm`` step
    blocks: the count, at most one slice a chunk, of least ``split_cost``
    (the fewest slices among equals).  A pure function of its arguments,
    not a knob; cached, since the search over counts costs more host time
    than a small step takes on the card."""
    bb, bh = tile
    tiles = _cdiv(H, bh) * _cdiv(B, bb)
    chunks = _cdiv(E, STEP_KC) + _cdiv(H, STEP_KC)
    return min(range(1, chunks + 1),
               key=lambda s: (split_cost(B, E, H, tiles, s, sms, per_sm), s))


def step_route(E: int, H: int, aligned: bool = True) -> str:
    """K3's copies: ``vec4`` (16 bytes) where E and H are multiples of 4 and
    the operands 16-byte aligned, else ``scalar`` (4 bytes)."""
    return "vec4" if aligned and E % 4 == 0 and H % 4 == 0 else "scalar"


@dataclass(frozen=True)
class SeqLaunch:
    """K4's cooperative launch (``gru_seq_launch``)."""

    blocks: int
    batch: int           # batch rows a launch: one launch a group of rows
    cols: int            # hidden columns per block, of all three gates
    threads: int
    lanes: int           # k-lanes: threads splitting a chunk's rows
    hp: int              # H padded to whole chunks: rows of a U panel
    rows_on_chip: int    # rows of each block's U panel in shared memory
    smem_bytes: int      # dynamic shared memory of a block
    u_bytes_on_chip: int  # bytes of U (all blocks) kept in shared memory
    u_bytes: int          # bytes of U


def _seq_fit(B: int, H: int, sms: int, smem_limit: int) -> SeqLaunch:
    """K4's partition for a launch of B <= SEQ_MAX_B batch rows, or a
    ValueError where its block cannot hold them."""
    rg = _cdiv(B, SEQ_RB)
    cols = _cdiv(H, sms)
    units = cols * rg
    if units > SEQ_THREADS:
        raise ValueError(f"gru_seq: {cols} columns x {rg} row groups a block "
                         f"exceed {SEQ_THREADS} threads (H={H}, sms={sms})")
    lanes = 1
    while lanes * 2 * units <= SEQ_THREADS and lanes * 2 <= SEQ_MAX_LANES:
        lanes *= 2
    hp = _cdiv(H, SEQ_KC) * SEQ_KC
    row = 3 * cols                            # floats of a U panel row
    h_stage = SEQ_RB * rg * (SEQ_KC + 4)      # floats of a chunk of h
    red = lanes * units * 3 * SEQ_RB          # the k-lane sums

    def ring(resident: bool) -> int:          # bytes of the staging ring
        stage = h_stage + (0 if resident else SEQ_KC * row)
        return 4 * max(SEQ_STAGES * stage, red)

    def panel(rows: int) -> int:              # bytes of the resident rows
        return 4 * _cdiv(rows * row, 4) * 4

    if panel(hp) + ring(True) <= smem_limit:
        rows = hp
    else:
        fit = (smem_limit - ring(False)) // (4 * row)
        rows = max(0, fit // SEQ_KC * SEQ_KC)
    smem = panel(rows) + ring(rows == hp)
    if smem > smem_limit:
        raise ValueError(f"gru_seq: {smem} B of shared memory a block, the "
                         f"card allows {smem_limit} (H={H}, sms={sms})")
    return SeqLaunch(blocks=_cdiv(H, cols), batch=B, cols=cols,
                     threads=SEQ_THREADS, lanes=lanes, hp=hp,
                     rows_on_chip=rows, smem_bytes=smem,
                     u_bytes_on_chip=4 * 3 * H * min(rows, H),
                     u_bytes=4 * 3 * H * H)


@functools.lru_cache(maxsize=None)
def gru_seq_launch(B: int, E: int, H: int, sms: int = H100_SMS,
                   smem_limit: int = MAX_SMEM_BYTES) -> SeqLaunch:
    """The partition of K4's recurrence over a card with ``sms`` SMs and
    ``smem_limit`` bytes of shared memory a block: ceil(H / sms) columns a
    block, so at most ``sms`` blocks (one per SM: the grid must be
    co-resident); a thread per (column, ``SEQ_RB`` batch rows) and as many
    k-lanes (a power of two) as the block's threads allow; the
    ``SEQ_STAGES``-deep ring that streams h (and the U rows that are not
    resident) through shared memory, which the k-lane sums reuse; and all
    rows of the block's U panel where they fit beside the ring, else as
    many whole chunks as fit beside a ring that also carries U.

    A launch takes ``batch`` rows: all B up to ``SEQ_MAX_B``, else groups of
    ``SEQ_MAX_B``, and fewer (halved, down to ``SEQ_RB``) where a block
    cannot hold a group's threads or ring at this H.  Raises ValueError
    where not even ``SEQ_RB`` rows fit (on an H100, H above 9504).  E does
    not enter (the projection is K2's).  A pure function."""
    if min(B, E, H, sms) < 1:
        raise ValueError(f"gru_seq_launch B={B} E={E} H={H} sms={sms}")
    rows = min(B, SEQ_MAX_B)
    while True:
        try:
            return _seq_fit(rows, H, sms, smem_limit)
        except ValueError:
            if rows <= SEQ_RB:
                raise
            rows = max(SEQ_RB, rows // 2 // SEQ_RB * SEQ_RB)


def pack_w(params: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's projection operands: [Wr|Wz|Wn] (E, 3H) and [br|bz|bnx] (3H,)."""
    return (torch.cat([params["Wr"], params["Wz"], params["Wn"]], 1),
            torch.cat([params["br"], params["bz"], params["bnx"]]))


def pack_u(params: dict, launch: SeqLaunch) -> torch.Tensor:
    """Each K4 block's U panel, contiguous: (blocks, Hp, 3, cols), block i
    holding columns [i cols, (i + 1) cols) of Ur, Uz, Un; rows >= H and
    columns >= H are zeros."""
    u = torch.stack([params["Ur"], params["Uz"], params["Un"]])  # (3, H, H)
    H = u.shape[1]
    padded = u.new_zeros((3, launch.hp, launch.blocks * launch.cols))
    padded[:, :H, :H] = u
    return padded.view(3, launch.hp, launch.blocks, launch.cols) \
        .permute(2, 1, 0, 3).contiguous()


#: the C entries of ``csrc/gru.cu``.  repro_gru_cell: BB, BH, vec, split;
#: x, h, the ten parameters, out, part; B, E, H; stream.  repro_gru_seq:
#: vec, blocks, cols, rows on chip, lanes, shared memory; G, h0, U panels,
#: bnh, buffers, out, barrier; T, B, G's rows a step, H, Hp; stream.
#: repro_gru_cell_occupancy: BB, BH, vec; out.  repro_gru_constants: out
STEP_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 14
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
SEQ_ARGTYPES = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 7
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
OCCUPANCY_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]
CONSTANTS_ARGTYPES = [ctypes.c_void_p]


def _bind(name: str, argtypes: list):
    lib = library("gru")
    _check_constants(lib)
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_constants(lib: ctypes.CDLL) -> None:
    """Raise unless the library's constants are ``C_CONSTANTS``: the launch
    plans above are computed from these copies."""
    fn = lib.repro_gru_constants
    fn.argtypes, fn.restype = CONSTANTS_ARGTYPES, ctypes.c_int
    got = (ctypes.c_int * len(C_CONSTANTS))()
    check(fn(got), "repro_gru_constants")
    if tuple(got) != C_CONSTANTS:
        raise RuntimeError(f"csrc/gru.cu defines {tuple(got)}, kernels/gru.py "
                           f"plans with {C_CONSTANTS}")


@functools.lru_cache(maxsize=None)
def _step_kernel():
    return _bind("repro_gru_cell", STEP_ARGTYPES)


@functools.lru_cache(maxsize=None)
def _seq_kernel():
    return _bind("repro_gru_seq", SEQ_ARGTYPES)


@functools.lru_cache(maxsize=None)
def step_blocks_per_sm(tile: tuple[int, int], route: str,
                       device: torch.device) -> int:
    """Resident blocks a SM of K3's step kernel at ``tile`` and ``route``
    on ``device``, from the CUDA occupancy calculator for this build."""
    bb, bh = _check_tile(tile)
    fn = _bind("repro_gru_cell_occupancy", OCCUPANCY_ARGTYPES)
    with torch.cuda.device(device):
        blocks = ctypes.c_int(0)
        check(fn(bb, bh, route == "vec4", ctypes.byref(blocks)),
              "gru_cell occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"gru_cell tile {tile} ({route}): no block fits "
                           f"on an SM of {device}")
    return blocks.value


def device_split(B: int, E: int, H: int, tile: tuple[int, int],
                 device: torch.device, route: str = "vec4") -> int:
    """``gru_split`` on ``device``: its SM count and the step kernel's
    resident blocks a SM there."""
    return gru_split(B, E, H, tuple(tile), device_sms(device),
                     step_blocks_per_sm(tuple(tile), route, device))


@functools.lru_cache(maxsize=None)
def device_smem(device: torch.device) -> int:
    """The shared memory one block of a CUDA device may opt in to."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin",
                       MAX_SMEM_BYTES))


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
    B, E = x.shape
    H = h.shape[1]
    weights = [params[n] for n in PARAM_NAMES[:6]]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, h, *weights))
    route = step_route(E, H, aligned)
    split = device_split(B, E, H, (bb, bh), x.device, route)
    part = torch.empty(4 * split * B * H, device=x.device) \
        if split > 1 else None
    check(_step_kernel()(
        bb, bh, route == "vec4", split, x.data_ptr(),
        h.data_ptr(), *(params[n].data_ptr() for n in PARAM_NAMES),
        out.data_ptr(), None if part is None else part.data_ptr(), B, E, H,
        stream_handle(x.device)), "gru_cell")
    gru_cell.launches += 1
    gru_cell_reduce.launches += split > 1
    return out


gru_cell.launches = 0


def gru_seq(xs: torch.Tensor, h0: torch.Tensor, params: dict,
            proj_tile: tuple[int, int, int] | None = None) -> torch.Tensor:
    """GRU over xs [T, B, E] from h0 [B, H]; returns the final hidden state.

    K2 projects the input of all T steps at ``proj_tile`` (``None``: its
    tuned or default tile), then the persistent recurrence kernel runs at
    ``gru_seq_launch`` on this card: one launch for B <= 64."""
    if xs.dim() != 3 or xs.shape[0] == 0:
        raise ValueError(f"gru_seq xs {tuple(xs.shape)}: want [T>0, B, E]")
    _check_operands(xs[0], h0, params)
    if xs.device.type == "cpu":
        return gru_seq_hoisted_ref(xs, h0, params)
    if not xs.is_contiguous():
        raise ValueError("gru_seq needs a contiguous xs")
    T, B, E = xs.shape
    H = h0.shape[1]
    launch = gru_seq_launch(B, E, H, device_sms(xs.device),
                            device_smem(xs.device))
    w, bias = pack_w(params)
    g = gemm_bias_act(xs.view(T * B, E), w, bias, "", tile=proj_tile)
    return _recurrence(g, h0, params, launch)


def _recurrence(g: torch.Tensor, h0: torch.Tensor, params: dict,
                launch: SeqLaunch) -> torch.Tensor:
    """K4's persistent kernel on G (T B, 3H) from h0 (B, H): one launch a
    group of ``launch.batch`` rows, in turn on the current stream."""
    B, H = h0.shape
    T = g.shape[0] // B
    dev = h0.device
    upack = pack_u(params, launch)
    out = torch.empty_like(h0)
    rows = min(B, launch.batch)
    # the two hidden-state buffers of a group, then the barrier's counter
    scratch = torch.empty(2 * rows * H + 4, device=dev)
    for b0 in range(0, B, rows):
        nb = min(rows, B - b0)
        check(_seq_kernel()(
            int(H % 4 == 0 and h0[b0].data_ptr() % 16 == 0), launch.blocks,
            launch.cols, launch.rows_on_chip, launch.lanes, launch.smem_bytes,
            g[b0].data_ptr(), h0[b0].data_ptr(), upack.data_ptr(),
            params["bnh"].data_ptr(), scratch.data_ptr(), out[b0].data_ptr(),
            scratch[2 * rows * H:].data_ptr(), T, nb, B, H, launch.hp,
            stream_handle(dev)), "gru_seq")
        gru_seq.launches += 1
    return out


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
