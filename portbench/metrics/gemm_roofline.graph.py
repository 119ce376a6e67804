"""The graph tier's GEMMs against their roofline: the least time of every
GEMM of the layer's equations at whole width (``entry.work``'s
``"gemm"``: (m, n, k, batch), each input byte read once and each output
written once) over the device time of K1's and K2's kernels, which share
their names, in %."""
from portbench.metrics.roofline import share
from portbench.peaks import ITEMSIZE

NAMES = ("transpose_kernel", "simt_kernel", "wgmma_kernel", "reduce_kernel")


def count(shape, dtype):
    m, n, k, batch = shape
    return (2.0 * batch * m * n * k,
            ITEMSIZE[dtype] * batch * (m * k + k * n + m * n))


def read(run):
    return share(run, "gemm", NAMES, count)
