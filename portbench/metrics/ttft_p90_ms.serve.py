"""ttft_p90_ms.serve: from a request's send to the end of the step that
admitted it (prefill and its first token), 90th percentile over the
requests admitted in the window, in ms (host clock)."""
from portbench.stats import percentile


def read(run):
    return percentile([(r["admitted"] - r["send"]) * 1e3
                       for r in run.requests if r["admitted"] is not None
                       and run.t0 < r["admitted"] <= run.t1], 90.0)
