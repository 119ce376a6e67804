"""One dtype-size table for the whole stack.

Three copies of this table used to live in ``core/scheduler.py``,
``launch/hlo_flops.py`` and ``launch/hlo_analysis.py``; they are consolidated
here so the ISAMIR scheduler, the HLO analyses and the fabric partitioner all
price bytes from the same source.  Names cover both the ISAMIR dtype
vocabulary (``f32``/``f64``/``bf16``/``i32``) and XLA's HLO element types
(``pred``/``s32``/``u8``/...).
"""
from __future__ import annotations

DTYPE_BYTES: dict[str, int] = {
    # ISAMIR buffer dtypes
    "f32": 4, "f64": 8, "bf16": 2, "i32": 4,
    # XLA HLO element types
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "f16": 2, "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "token": 0,
}


def dtype_bytes(name: str, default: int = 4) -> int:
    """Bytes per element of ``name``; unknown dtypes fall back to f32."""
    return DTYPE_BYTES.get(name, default)
