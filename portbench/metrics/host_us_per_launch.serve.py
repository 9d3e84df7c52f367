"""host_us_per_launch.serve: the host wall of the window's forward spans
(``prefill.forward`` and ``decode.forward``) over the kernels and copies
they launched, in us. Each device op is put down to the launching span it
starts after (``lm_trace.owners``): the kernels' start stands in for
their launch, which holds where the card keeps up with the host."""
from portbench import lm_trace


def read(run):
    lm = lm_trace.of(run)
    if lm is None or not run.kernels:
        return None
    return lm_trace.host_us_per_launch(lm, run.kernels, run.t0, run.t1)
