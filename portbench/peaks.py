"""The card's data-sheet peaks: the yardstick of every roofline and ``mfu``.

NVIDIA H100 SXM (80 GB HBM3) at its 700 W power limit, dense rates without
sparsity.  These are published figures, not measurements, and not the
port's own constants: a change to the program cannot move them.
"""

#: FLOP/s by operand dtype: the tensor cores for bf16, the CUDA cores
#: (no TF32) for f32
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: HBM3 bytes/s
PEAK_BYTES = 3.35e12
#: bytes of an element by dtype name
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card can take for ``flops`` operations on
    ``dtype`` operands that move ``nbytes``: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
