"""``tflops`` in the cells whose judged end-to-end metric is ``p95_ms`` alone
(the host-bound GEMM cells): the same reader, of the same window.  There
the host's speed sets the rate, which drifts more from run to run than any
bound allows, so it is read beside the tail and not judged."""
from portbench.metrics.tflops import read  # noqa: F401
