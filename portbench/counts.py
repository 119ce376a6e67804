"""The algorithms' operation counts, from the shapes alone: what ``tflops``
and ``mfu`` count as a request's work, whatever the kernels do."""


def gemm_flops(m: int, n: int, k: int) -> float:
    """C = A @ B with A (m, k), B (k, n): a multiply and an add per term."""
    return 2.0 * m * n * k


def gru_step_flops(batch: int, inp: int, hidden: int) -> float:
    """One GRU step: x (B, E) times the three W (E, H) and h (B, H) times the
    three U (H, H).  The gates' elementwise work is not counted."""
    return 6.0 * batch * hidden * (inp + hidden)


def gru_seq_flops(steps: int, batch: int, inp: int, hidden: int) -> float:
    """A GRU sequence of ``steps`` steps: 12 H^2 B T where E = H."""
    return steps * gru_step_flops(batch, inp, hidden)
