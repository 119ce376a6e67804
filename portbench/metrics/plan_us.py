"""What a request pays in the compiler before it launches: the host time of
the program's own planning calls (``plan_gemm``, ``plan_gru``) of one
request, with the memo warm, averaged over ``ROUNDS`` rounds of every
request class, in us."""
import time

ROUNDS = 100


def read(run):
    entry = run.entry
    n = len(entry.classes)
    t = time.perf_counter()
    for _ in range(ROUNDS):
        for cls in range(n):
            entry.plan((cls, 0))
    return (time.perf_counter() - t) / (ROUNDS * n) * 1e6
