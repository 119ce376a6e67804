"""From the start of the process to the opening of the window, in s:
loading, the kernels' build where it is not built yet, inputs and weights,
the timed compiles and the warm-up."""


def read(run):
    return run.setup_s
