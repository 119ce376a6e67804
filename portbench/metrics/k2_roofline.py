"""K2's roofline share, as the GRU sequence's input projection runs it
(``gemm.projection``): G = X @ W + b with X (m, k), W (k, n) in the operand
dtype, b (n,) and G (m, n) in f32; its device time is its transposing pass,
main loop and split-K reduce."""
from portbench.metrics.roofline import share
from portbench.peaks import ITEMSIZE

NAMES = ("transpose_kernel", "simt_kernel", "wgmma_kernel", "reduce_kernel")


def count(shape, dtype):
    m, n, k = shape
    return (2.0 * m * n * k,
            ITEMSIZE[dtype] * (m * k + k * n) + 4 * (n + m * n))


def read(run):
    return share(run, "k2", NAMES, count)
