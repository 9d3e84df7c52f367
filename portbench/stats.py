"""Statistics over raw samples: percentiles by linear interpolation
between the closest ranks (numpy's default), never from buckets."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (0..100) of ``values``; None when empty."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float | None:
    return percentile(values, 50.0)
