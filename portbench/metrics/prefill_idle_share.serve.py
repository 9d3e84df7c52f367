"""prefill_idle_share.serve: share of the wall of the window's ``admit``
spans (a prompt's prefill program, slab insert and first-token readback)
with no kernel or copy running on the card (torch.profiler), in %."""
from portbench import lm_trace


def read(run):
    lm = lm_trace.of(run)
    if lm is None or not run.kernels:
        return None
    return lm_trace.idle_share(run.kernels, [
        (s[1], s[2]) for s in lm_trace.spans_named(lm, ("admit",))])
