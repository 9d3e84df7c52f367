"""prefill_ms_per_ktok.serve: wall of the window's admitting steps less
the median step that admitted nothing, per 1,000 prompt tokens admitted
(host clock)."""
from portbench.stats import median


def read(run):
    steps = run.window_steps()
    decode = median([(s["t1"] - s["t0"]) * 1e3 for s in steps
                     if not s["admitted"]])
    admit = [s for s in steps if s["admitted"]]
    tokens = sum(s["prefill_tokens"] for s in admit)
    if decode is None or not tokens:
        return None
    extra = sum((s["t1"] - s["t0"]) * 1e3 - decode for s in admit)
    return extra / (tokens / 1e3)
