"""device_idle_share.serve: share of the traced window in which no kernel
or copy ran on the card (torch.profiler), in %."""
from portbench import trace


def read(run):
    if not run.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s(run.kernels, run.t0, run.t1)
                    / run.window_s)
