"""K3 and K4: the fused GRU cell and the GRU sequence (paper Figure 4).

``gru_cell`` (K3) launches the hand-written CUDA step in ``csrc/gru.cu``:
all three gates and the state update of one step, over a grid of
(hidden tile, reduction slice, batch tile) blocks.  The reduction over E
(x W) and H (h U) is cut into ``gru_split`` slices so that a step fills
the card in whole waves; with more than one slice a second kernel adds the
slices' partial sums in slice order and applies the gate epilogue
(the counter ``gru_cell_reduce`` counts it).

``gru_seq`` (K4) takes one of two routes, by a rule fixed from the shapes
before any launch (``seq_route``), never as a fallback:

* ``persistent`` — the input projection is hoisted out of the recurrence:
  K2's launch (``gemm.projection``) computes G = xs [T B, E] @ [Wr|Wz|Wn] +
  [br|bz|bnx] for all T steps in one product, in f32, and one cooperative
  CUDA kernel runs the T steps of h [Ur|Uz|Un], each block keeping its
  panel of U in shared memory where it fits (``gru_seq_launch``).  Two
  launches a sequence of up to 64 batch rows, no K3; a larger batch takes
  one recurrence launch for each group of rows (``SeqLaunch.batch``).
* ``step`` — where no block of the persistent kernel can hold its share of
  a step (on an H100, f32 above H = 9504): T launches of K3, one a step,
  alternating two hidden-state buffers (``gru_seq_steps``).

The packed operands ([Wr|Wz|Wn], each block's U panel) are built on every
call from the parameters as they are then (``pack_w``, ``pack_u``): a
cached copy could go stale when a buffer is written in place, and the
copies take tens of microseconds against a sequence of milliseconds.

Operands are f32 or bf16, one dtype for all: the kernels widen every load
to f32, compute in f32 (K4's bf16 products on the tensor cores, summed in
f32: ``seq_mma``) and store h' in the operand type, so a sequence rounds h
after every step, as the JAX package's ``lax.scan`` does; G stays f32.
On CPU tensors both run the plain versions (``ref.gru_cell_ref``; for the
sequence the chosen route's: ``ref.gru_seq_hoisted_ref`` or a loop of
``ref.gru_cell_ref``); on CUDA tensors they launch the kernels or raise.
``tile=(BB, BH)`` is one K3 block's (batch, hidden) tile, normally chosen
by ``ops.gru_tile`` from the compiler's GRU plan.  ``FusedGRU`` holds the
ten parameters (``PARAM_NAMES``) as buffers of an ``nn.Module``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..telemetry import count, span
from .cuda import (MAX_SMEM_BYTES, check, library, resolve_device,
                   stream_handle)
from .gemm import DTYPES, H100_SMS, device_sms, projection
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
#: batch rows per thread (f32; the staged rows come in groups of as many),
#: the most batch rows a launch and k-lanes (f32)
SEQ_THREADS = 512
SEQ_KC = 64
SEQ_STAGES = 4
SEQ_RB = 8
SEQ_MAX_B = 64
SEQ_MAX_LANES = SEQ_KC // 4
#: K4 on bf16 operands: the m64 tiles of a block's panel rows its
#: tensor-core loop takes (two a warpgroup)
SEQ_MMA_TILES = 8
#: the constants above as ``csrc/gru.cu`` defines them, in the order its
#: ``repro_gru_constants`` writes them; checked when the library is bound
C_CONSTANTS = (STEP_KC, SEQ_THREADS, SEQ_KC, SEQ_STAGES, SEQ_RB, SEQ_MAX_B,
               SEQ_MMA_TILES)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_cost(B: int, E: int, H: int, tiles: int, split: int,
               sms: int = H100_SMS, per_sm: int = STEP_BLOCKS_PER_SM,
               esize: int = 4) -> float:
    """The modeled time of a K3 step cut into ``split`` slices, relative to
    one that streams the weights at full rate on every SM: the waves of
    ``per_sm`` resident blocks a SM the grid takes, over the
    waves it would take if it divided evenly, times the bytes moved (the
    weights of ``esize`` bytes, 3 esize H (E + H), plus the split's f32
    partials written and read back, 2 x 16 split B H) over the weights'
    bytes."""
    slots = per_sm * sms
    blocks = tiles * split
    waves = -(-blocks // slots)
    partials = 32 * split * B * H if split > 1 else 0
    return waves * slots / blocks * (1 + partials / (3 * esize * H * (E + H)))


@functools.lru_cache(maxsize=None)
def gru_split(B: int, E: int, H: int, tile: tuple[int, int],
              sms: int = H100_SMS, per_sm: int = STEP_BLOCKS_PER_SM,
              esize: int = 4) -> int:
    """How many slices K3's reduction (ceil(E / STEP_KC) + ceil(H / STEP_KC)
    chunks) is cut into on ``sms`` SMs that each hold ``per_sm`` step
    blocks, for operands of ``esize`` bytes: the count, at most one slice a
    chunk, of least ``split_cost`` (the fewest slices among equals).  A
    pure function of its arguments, not a knob; cached, since the search
    over counts costs more host time than a small step takes on the
    card."""
    bb, bh = tile
    tiles = _cdiv(H, bh) * _cdiv(B, bb)
    chunks = _cdiv(E, STEP_KC) + _cdiv(H, STEP_KC)
    return min(range(1, chunks + 1),
               key=lambda s: (split_cost(B, E, H, tiles, s, sms, per_sm,
                                         esize), s))


def step_route(E: int, H: int, aligned: bool = True) -> str:
    """K3's copies: ``vec4`` (4 elements: 16 bytes of f32, 8 of bf16) where
    E and H are multiples of 4 and the operands aligned to 4 elements, else
    ``scalar`` (one element)."""
    return "vec4" if aligned and E % 4 == 0 and H % 4 == 0 else "scalar"


@dataclass(frozen=True)
class SeqLaunch:
    """K4's cooperative launch (``gru_seq_launch``)."""

    blocks: int
    batch: int           # batch rows a launch: one launch a group of rows
    cols: int            # hidden columns per block, of all three gates
    threads: int
    lanes: int           # f32: k-lanes, threads splitting a chunk's rows
                         # (bf16 takes none: 1)
    hp: int              # H padded to whole chunks: rows of a U panel
    row: int             # elements of a U panel row: 3 cols (bf16: padded
                         # with zeros to whole m16 tiles)
    rows_on_chip: int    # rows of each block's U panel in shared memory
    smem_bytes: int      # dynamic shared memory of a block
    u_bytes_on_chip: int  # bytes of U (all blocks) kept in shared memory
    u_bytes: int          # bytes of U


def seq_mma(dtype: torch.dtype) -> bool:
    """Whether K4 takes the tensor-core inner product (``csrc/gru.cu``
    kSeqMma): for bf16 operands; f32 keeps the fmaf loop (TF32 would fall
    below f32's precision)."""
    return dtype == torch.bfloat16


def seq_hs(esize: int) -> int:
    """Elements of a staged row of h (``csrc/gru.cu`` seq_hs): SEQ_KC and a
    16-byte pad; bf16 (wgmma's core matrices), SEQ_KC."""
    return SEQ_KC if esize == 2 else SEQ_KC + 16 // esize


def seq_row(cols: int, esize: int) -> int:
    """Elements of a K4 U panel row (``csrc/gru.cu`` seq_row): the 3 cols
    columns, bf16 padded with zeros to whole m16 tiles."""
    return _cdiv(3 * cols, 16) * 16 if esize == 2 else 3 * cols


def _seq_fit(B: int, H: int, sms: int, smem_limit: int,
             esize: int) -> tuple[SeqLaunch | None, str]:
    """K4's partition for a launch of B <= SEQ_MAX_B batch rows of operands
    of ``esize`` bytes, or (None, why its block cannot hold them).  f32
    (esize 4) takes the fmaf loop, bf16 (esize 2) the tensor cores."""
    rg = _cdiv(B, SEQ_RB)
    cols = _cdiv(H, sms)
    row = seq_row(cols, esize)                # elements of a U panel row
    h_stage = SEQ_RB * rg * seq_hs(esize)     # elements of a chunk of h
    if esize == 2:
        tiles = _cdiv(3 * cols, 64)
        if tiles > SEQ_MMA_TILES:
            return None, (f"gru_seq: {cols} columns a block take {tiles} "
                          f"m64 tiles, the tensor-core loop "
                          f"{SEQ_MMA_TILES} (H={H}, sms={sms})")
        lanes = 1
        red = 4 * (row + 4) * SEQ_RB * rg       # bytes of the step's sums
    else:
        units = cols * rg
        if units > SEQ_THREADS:
            return None, (f"gru_seq: {cols} columns x {rg} row groups a "
                          f"block exceed {SEQ_THREADS} threads (H={H}, "
                          f"sms={sms})")
        lanes = 1
        while lanes * 2 * units <= SEQ_THREADS \
                and lanes * 2 <= SEQ_MAX_LANES:
            lanes *= 2
        red = 4 * lanes * units * 3 * SEQ_RB  # bytes of the k-lane sums
    hp = _cdiv(H, SEQ_KC) * SEQ_KC

    def ring(resident: bool) -> int:          # bytes of the staging ring
        stage = h_stage + (0 if resident else SEQ_KC * row)
        return max(SEQ_STAGES * stage * esize, red)

    def panel(rows: int) -> int:              # bytes of the resident rows
        return _cdiv(rows * row * esize, 16) * 16

    if panel(hp) + ring(True) <= smem_limit:
        rows = hp
    else:
        fit = (smem_limit - ring(False)) // (esize * row)
        rows = max(0, fit // SEQ_KC * SEQ_KC)
    smem = panel(rows) + ring(rows == hp)
    if smem > smem_limit:
        return None, (f"gru_seq: {smem} B of shared memory a block, the card "
                      f"allows {smem_limit} (H={H}, sms={sms})")
    return SeqLaunch(blocks=_cdiv(H, cols), batch=B, cols=cols,
                     threads=SEQ_THREADS, lanes=lanes, hp=hp, row=row,
                     rows_on_chip=rows, smem_bytes=smem,
                     u_bytes_on_chip=esize * 3 * H * min(rows, H),
                     u_bytes=esize * 3 * H * H), ""


@functools.lru_cache(maxsize=None)
def _seq_partition(B: int, H: int, sms: int, smem_limit: int,
                   esize: int) -> tuple[SeqLaunch | None, str]:
    """``gru_seq_launch``'s search over the rows a launch takes: (the
    partition, "") or (None, why not even ``SEQ_RB`` rows fit)."""
    rows = min(B, SEQ_MAX_B)
    while True:
        launch, why = _seq_fit(rows, H, sms, smem_limit, esize)
        if launch is not None or rows <= SEQ_RB:
            return launch, why
        rows = max(SEQ_RB, rows // 2 // SEQ_RB * SEQ_RB)


def _check_dims(B: int, E: int, H: int, sms: int, dtype: torch.dtype) -> int:
    """The element size of ``dtype``, after checking the dimensions."""
    if min(B, E, H, sms) < 1:
        raise ValueError(f"gru_seq_launch B={B} E={E} H={H} sms={sms}")
    return dtype.itemsize


def gru_seq_launch(B: int, E: int, H: int, sms: int = H100_SMS,
                   smem_limit: int = MAX_SMEM_BYTES,
                   dtype: torch.dtype = torch.float32) -> SeqLaunch:
    """The partition of K4's recurrence over a card with ``sms`` SMs and
    ``smem_limit`` bytes of shared memory a block, for operands of
    ``dtype``: ceil(H / sms) columns a block, so at most ``sms`` blocks (one
    per SM: the grid must be co-resident); the ``SEQ_STAGES``-deep ring
    that streams h (and the U rows that are not resident) through shared
    memory, which the step's partial sums reuse; and all rows of the
    block's U panel where they fit beside the ring, else as many whole
    chunks as fit beside a ring that also carries U.

    The inner product follows the dtype.  f32 keeps the fmaf loop: a
    thread per (column, ``SEQ_RB`` batch rows) and as many k-lanes (a power
    of two) as the block's threads allow.  bf16 takes the tensor cores: a
    panel row of 3 cols padded to whole m16 tiles (``seq_row``), at most
    ``SEQ_MMA_TILES`` m64 tiles, one warpgroup a tile running the chunk
    loop (up to four, which the kernel counts from cols): what is left of a
    step is then h from L2, the epilogue and the grid barrier.  A bf16 chunk of h takes half
    the bytes of an f32 one.

    A launch takes ``batch`` rows: all B up to ``SEQ_MAX_B``, else groups of
    ``SEQ_MAX_B``, and fewer (halved, down to ``SEQ_RB``) where a block
    cannot hold a group's threads or ring at this H.  Raises ValueError
    where not even ``SEQ_RB`` rows fit (on an H100, f32 above H = 9504,
    bf16 above 19008: ``seq_route`` then says ``step``).  E does not enter
    (the projection is K2's).  A pure function of (B, H, sms, smem_limit,
    dtype)."""
    esize = _check_dims(B, E, H, sms, dtype)
    launch, why = _seq_partition(B, H, sms, smem_limit, esize)
    if launch is None:
        raise ValueError(why)
    return launch


def seq_route(B: int, E: int, H: int, dtype: torch.dtype = torch.float32,
              sms: int = H100_SMS, smem: int = MAX_SMEM_BYTES) -> str:
    """K4's route for a sequence of B rows: ``persistent`` where
    ``gru_seq_launch`` can place the recurrence on a card of ``sms`` SMs
    with ``smem`` bytes of shared memory a block, else ``step`` (T launches
    of K3, which takes any H).  A pure function of the shapes, decided
    before any launch."""
    esize = _check_dims(B, E, H, sms, dtype)
    launch, _ = _seq_partition(B, H, sms, smem, esize)
    return "persistent" if launch is not None else "step"


def pack_w(params: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's projection operands: [Wr|Wz|Wn] (E, 3H) and [br|bz|bnx] (3H,)."""
    return (torch.cat([params["Wr"], params["Wz"], params["Wn"]], 1),
            torch.cat([params["br"], params["bz"], params["bnx"]]))


def pack_u(params: dict, launch: SeqLaunch) -> torch.Tensor:
    """Each K4 block's U panel, one contiguous tensor, in the layout its
    inner product reads.  Panel i holds columns [i cols, (i + 1) cols) of
    Ur, Uz, Un; its row k is U's row k, (3, cols); rows >= H and columns
    >= H are zeros.

    f32 (the fmaf loop): (blocks, Hp, 3, cols).  bf16 (the tensor cores):
    each row padded with zeros to ``launch.row`` (whole m16 tiles), and
    every 16 rows x 16 of its elements stored as ldmatrix reads four 8 x 8
    matrices: (blocks, Hp / 16, row / 16, 2, 2, 8, 8), indexed (block, k //
    16, m // 16, k // 8 % 2, m // 8 % 2, k % 8, m % 8) for element m of
    row k.  The 16-row groups stay in row order, so whole chunks of rows
    are contiguous either way."""
    u = torch.stack([params["Ur"], params["Uz"], params["Un"]])  # (3, H, H)
    H = u.shape[1]
    blocks, cols, hp = launch.blocks, launch.cols, launch.hp
    padded = u.new_zeros((3, hp, blocks * cols))
    padded[:, :H, :H] = u
    panels = padded.view(3, hp, blocks, cols).permute(2, 1, 0, 3)
    if not seq_mma(u.dtype):
        return panels.contiguous()
    rows = u.new_zeros((blocks, hp, launch.row))
    rows[..., :3 * cols].unflatten(2, (3, cols)).copy_(panels)
    return rows.view(blocks, hp // 16, 2, 8, launch.row // 16, 2, 8) \
        .permute(0, 1, 4, 2, 5, 3, 6).contiguous()


#: the C entries of ``csrc/gru.cu``.  repro_gru_cell: dtype, BB, BH, vec,
#: split; x, h, the ten parameters, out, part; B, E, H; stream.
#: repro_gru_seq: dtype, vec, blocks, cols, rows on chip, lanes, shared
#: memory; G, h0, U panels, bnh, buffers, out, barrier; T, B, G's rows a
#: step, H, Hp; stream.  repro_gru_cell_occupancy: dtype, BB, BH, vec; out.
#: repro_gru_constants: out
STEP_ARGTYPES = ([ctypes.c_int] * 5 + [ctypes.c_void_p] * 14
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
SEQ_ARGTYPES = ([ctypes.c_int] * 7 + [ctypes.c_void_p] * 7
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
OCCUPANCY_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
                       device: torch.device,
                       dtype: torch.dtype = torch.float32) -> int:
    """Resident blocks a SM of K3's step kernel for ``dtype`` operands at
    ``tile`` and ``route`` on ``device``, from the CUDA occupancy
    calculator for this build."""
    bb, bh = _check_tile(tile)
    fn = _bind("repro_gru_cell_occupancy", OCCUPANCY_ARGTYPES)
    with torch.cuda.device(device):
        blocks = ctypes.c_int(0)
        check(fn(DTYPES[dtype], bb, bh, route == "vec4",
                 ctypes.byref(blocks)), "gru_cell occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"gru_cell tile {tile} ({route}): no block fits "
                           f"on an SM of {device}")
    return blocks.value


def device_split(B: int, E: int, H: int, tile: tuple[int, int],
                 device: torch.device, route: str = "vec4",
                 dtype: torch.dtype = torch.float32) -> int:
    """``gru_split`` on ``device``: its SM count and the step kernel's
    resident blocks a SM there, for ``dtype`` operands."""
    return gru_split(B, E, H, tuple(tile), device_sms(device),
                     step_blocks_per_sm(tuple(tile), route, device, dtype),
                     dtype.itemsize)


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
    on a CUDA device: one device, one dtype (f32 or bf16), contiguous."""
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
    if x.dtype not in DTYPES:
        raise ValueError(f"gru x: dtype {x.dtype}, need one of "
                         f"{list(DTYPES)}")
    for name, t in (("x", x), ("h", h), *((n, params[n]) for n in PARAM_NAMES)):
        if t.device != x.device or t.dtype != x.dtype \
                or not t.is_contiguous():
            raise ValueError(f"gru {name}: need contiguous {x.dtype} on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if min(x.shape[0], E, H) == 0:
        raise ValueError("gru with an empty dimension")


def gru_cell(x: torch.Tensor, h: torch.Tensor, params: dict,
             tile: tuple[int, int] = DEFAULT_TILE,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """One fused GRU step: x (B, E), h (B, H) -> h' (B, H).  ``out``, when
    given, receives h' and must not be ``h``'s storage."""
    with span("k3"):
        with span("k3.check"):
            bb, bh = _check_tile(tile)
            _check_operands(x, h, params)
            if out is not None and x.device.type != "cpu":
                if out.shape != h.shape or out.dtype != h.dtype \
                        or out.device != h.device or not out.is_contiguous():
                    raise ValueError("gru_cell out must be a contiguous "
                                     "tensor like h")
                if out.data_ptr() == h.data_ptr():
                    raise ValueError("gru_cell out must not alias h")
        if x.device.type == "cpu":
            return gru_cell_ref(x, h, params)
        B, E = x.shape
        H = h.shape[1]
        weights = [params[n] for n in PARAM_NAMES[:6]]
        aligned = all(t.data_ptr() % (4 * x.element_size()) == 0
                      for t in (x, h, *weights))
        route = step_route(E, H, aligned)
        split = device_split(B, E, H, (bb, bh), x.device, route, x.dtype)
        with span("k3.alloc"):
            if out is None:
                out = torch.empty_like(h)
            part = torch.empty(4 * split * B * H, device=x.device) \
                if split > 1 else None
        with span("k3.call"):
            check(_step_kernel()(
                DTYPES[x.dtype], bb, bh, route == "vec4", split,
                x.data_ptr(), h.data_ptr(),
                *(params[n].data_ptr() for n in PARAM_NAMES),
                out.data_ptr(), None if part is None else part.data_ptr(),
                B, E, H, stream_handle(x.device)), "gru_cell")
    count("gru_cell.launches")
    if split > 1:
        count("gru_cell_reduce")
    return out


def gru_seq(xs: torch.Tensor, h0: torch.Tensor, params: dict,
            proj_tile: tuple[int, int, int] | None = None,
            step_tile: tuple[int, int] = DEFAULT_TILE) -> torch.Tensor:
    """GRU over xs [T, B, E] from h0 [B, H]; returns the final hidden state.

    The route is ``seq_route`` on this card (on a CPU tensor, on an H100).
    ``persistent``: K2's launch projects the input of all T steps at
    ``proj_tile`` (``None``: its tuned or default tile), then the persistent
    recurrence kernel runs at ``gru_seq_launch``: one launch for B <= 64.
    ``step``: ``gru_seq_steps``, T launches of K3 at ``step_tile``."""
    with span("k4"):
        if xs.dim() != 3 or xs.shape[0] == 0:
            raise ValueError(f"gru_seq xs {tuple(xs.shape)}: want "
                             f"[T>0, B, E]")
        _check_operands(xs[0], h0, params)
        T, B, E = xs.shape
        H = h0.shape[1]
        cpu = xs.device.type == "cpu"
        sms = H100_SMS if cpu else device_sms(xs.device)
        smem = MAX_SMEM_BYTES if cpu else device_smem(xs.device)
        if seq_route(B, E, H, xs.dtype, sms, smem) == "step":
            return gru_seq_steps(xs, h0, params, step_tile)
        if cpu:
            return gru_seq_hoisted_ref(xs, h0, params)
        if not xs.is_contiguous():
            raise ValueError("gru_seq needs a contiguous xs")
        launch = gru_seq_launch(B, E, H, sms, smem, xs.dtype)
        with span("k4.pack_w"):
            w, bias = pack_w(params)
        g = projection(xs.view(T * B, E), w, bias, tile=proj_tile)
        return _recurrence(g, h0, params, launch)


def gru_seq_steps(xs: torch.Tensor, h0: torch.Tensor, params: dict,
                  tile: tuple[int, int] = DEFAULT_TILE) -> torch.Tensor:
    """K4's step route: one K3 launch a step on ``xs[t]`` at ``tile``,
    alternating two hidden-state buffers, so that h is rounded to the
    operand type after every step as in the JAX scan.  On CPU tensors, the
    loop of K3's plain version."""
    if xs.dim() != 3 or xs.shape[0] == 0:
        raise ValueError(f"gru_seq xs {tuple(xs.shape)}: want [T>0, B, E]")
    if xs.device.type == "cpu":
        h = h0
        for x in xs:
            h = gru_cell(x, h, params, tile=tile)
        return h
    if not xs.is_contiguous():
        raise ValueError("gru_seq needs a contiguous xs")
    bufs = torch.empty((2, *h0.shape), dtype=h0.dtype, device=h0.device)
    h = h0
    for t, x in enumerate(xs):
        h = gru_cell(x, h, params, tile=tile, out=bufs[t % 2])
    return h


def _recurrence(g: torch.Tensor, h0: torch.Tensor, params: dict,
                launch: SeqLaunch) -> torch.Tensor:
    """K4's persistent kernel on G (T B, 3H, f32) from h0 (B, H): one
    launch a group of ``launch.batch`` rows, in turn on the current
    stream."""
    B, H = h0.shape
    T = g.shape[0] // B
    dev = h0.device
    with span("k4.pack_u"):
        upack = pack_u(params, launch)
    rows = min(B, launch.batch)
    esize = h0.element_size()
    # the two hidden-state buffers of a group, then the barrier's counter
    buf_bytes = -(-2 * rows * H * esize // 16) * 16
    with span("k4.alloc"):
        out = torch.empty_like(h0)
        scratch = torch.empty(buf_bytes + 16, dtype=torch.uint8, device=dev)
    mma = seq_mma(h0.dtype)
    for b0 in range(0, B, rows):
        nb = min(rows, B - b0)
        vec = H % (16 // esize) == 0 and h0[b0].data_ptr() % 16 == 0
        with span("k4.call"):
            check(_seq_kernel()(
                DTYPES[h0.dtype], int(vec), launch.blocks, launch.cols,
                launch.rows_on_chip, launch.lanes, launch.smem_bytes,
                g[b0].data_ptr(), h0[b0].data_ptr(), upack.data_ptr(),
                params["bnh"].data_ptr(), scratch.data_ptr(),
                out[b0].data_ptr(), scratch.data_ptr() + buf_bytes, T, nb, B,
                H, launch.hp, stream_handle(dev)), "gru_seq")
        count("gru_seq.launches")
        if mma:
            count("gru_seq.mma")
    return out


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
