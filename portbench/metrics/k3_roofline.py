"""K3's roofline share: one GRU step (``csrc/gru.cu``: the step kernel and
its split reduce) on x (B, E), h (B, H), the six weight matrices and four
biases, writing h' (B, H)."""
from portbench.metrics.roofline import share
from portbench.peaks import ITEMSIZE

NAMES = ("gru_step_kernel", "gru_sum_kernel")


def count(shape, dtype):
    b, e, h = shape
    return (6.0 * b * h * (e + h),
            ITEMSIZE[dtype] * (3 * e * h + 3 * h * h + 4 * h
                               + b * e + 2 * b * h))


def read(run):
    return share(run, "k3", NAMES, count)
