"""K4's recurrence's roofline share (``csrc/gru.cu``, the persistent kernel):
T steps of h [Ur|Uz|Un] from the f32 projection G (T B, 3H), h0 (B, H) and
bnh (H,), writing the final h (B, H); U is read once."""
from portbench.metrics.roofline import share
from portbench.peaks import ITEMSIZE

NAMES = ("gru_seq_kernel",)


def count(shape, dtype):
    t, b, h = shape
    return (6.0 * t * b * h * h,
            ITEMSIZE[dtype] * (3 * h * h + h + 2 * b * h) + 4 * 3 * t * b * h)


def read(run):
    return share(run, "k4", NAMES, count)
