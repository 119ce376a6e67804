"""The mean time of one fresh compile of the cell's program set through
``repro_torch.compile.driver`` (memo cleared, no persistent cache), timed
in set-up, in s."""


def read(run):
    return run.compile_s
