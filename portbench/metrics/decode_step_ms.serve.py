"""decode_step_ms.serve: host wall of the window's
``ContinuousBatcher.step()`` calls that admitted nothing (every slot
decodes one token), median, in ms."""
from portbench.stats import median


def read(run):
    return median([(s["t1"] - s["t0"]) * 1e3 for s in run.window_steps()
                   if not s["admitted"]])
