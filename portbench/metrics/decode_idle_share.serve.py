"""decode_idle_share.serve: share of the wall of the window's decodes
(each step's ``decode.forward`` and the readback after it) with no kernel
or copy running on the card (torch.profiler), in %."""
from portbench import lm_trace


def read(run):
    lm = lm_trace.of(run)
    if lm is None or not run.kernels:
        return None
    return lm_trace.idle_share(run.kernels, lm_trace.decode_windows(lm))
