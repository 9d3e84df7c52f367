"""request_p90_ms: from a request's send to the end of the step that gave
its last token, the 90th percentile over every request done in the window
(host clock)."""
from portbench.stats import percentile


def read(run):
    lat = [(r["done"] - r["send"]) * 1e3 for r in run.requests
           if r["done"] is not None and run.t0 < r["done"] <= run.t1]
    return percentile(lat, 90.0)
