"""The host time of a request in the bridge's reading of the conv plan:
inside the ``plan.extract`` spans (``ops.plan_conv``: the check that the
extraction is one GEMM, its shape and block) of the span slice, per
request, in us (``spans.py``).  Nothing where the program records no
``plan.extract`` span."""
from portbench.metrics.spans import measure


def read(run):
    sl = measure(run)
    if sl is None or "plan.extract" not in sl.by_name:
        return None
    return sl.by_name["plan.extract"][1] / sl.requests / 1e3
