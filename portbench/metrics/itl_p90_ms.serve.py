"""itl_p90_ms.serve: the gap between a request's consecutive tokens (each
token's time is when the readback that gave it returned, on the program's
request track), 90th percentile over the gaps inside the window, in ms."""
from portbench import lm_trace
from portbench.stats import percentile


def read(run):
    lm = lm_trace.of(run)
    if lm is None:
        return None
    gaps = []
    for r in lm["requests"]:
        ts = [t for t in r.get("token_times", ()) if run.t0 <= t <= run.t1]
        gaps += [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]
    return percentile(gaps, 90.0)
