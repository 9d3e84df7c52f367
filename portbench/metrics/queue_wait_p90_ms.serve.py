"""queue_wait_p90_ms.serve: a request's ``queue_wait`` phase (from its
submit to the start of its own admission, on the program's request track),
90th percentile over the requests admitted in the window, in ms."""
from portbench import lm_trace
from portbench.stats import percentile


def read(run):
    lm = lm_trace.of(run)
    if lm is None:
        return None
    return percentile([(sp["t1"] - sp["t0"]) * 1e3 for r in lm["requests"]
                       for sp in r["spans"] if sp["name"] == "queue_wait"
                       and run.t0 < sp["t1"] <= run.t1], 90.0)
