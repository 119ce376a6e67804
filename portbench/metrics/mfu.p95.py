"""``mfu`` in the cells whose judged end-to-end metric is ``p95_ms`` alone
(the host-bound GEMM cells, which report no ``tflops``): the same reader."""
from portbench.metrics.mfu import read  # noqa: F401
