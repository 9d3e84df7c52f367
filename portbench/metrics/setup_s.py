"""setup_s: seconds from the process's start to the window's start:
imports, the kernels' build or load, the weights, registration and the
warm-up the cell's traffic needs (host clock)."""


def read(run):
    return run.setup_s
