"""K1's roofline share: the GEMM C = A @ B (``csrc/gemm.cu``, ``hopper.cuh``),
its device time being its transposing pass, main loop and split-K reduce."""
from portbench.metrics.roofline import share
from portbench.peaks import ITEMSIZE

NAMES = ("transpose_kernel", "simt_kernel", "wgmma_kernel", "reduce_kernel")


def count(shape, dtype):
    m, n, k = shape
    return 2.0 * m * n * k, ITEMSIZE[dtype] * (m * k + k * n + m * n)


def read(run):
    return share(run, "k1", NAMES, count)
