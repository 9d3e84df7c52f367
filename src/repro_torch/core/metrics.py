"""Lightweight counters/histograms for runtime accounting.

Thread-safety contract: every public operation — ``inc``, ``observe``,
``timeit``, ``snapshot``, and the ``Histogram`` accessors — may be called
from any number of threads concurrently (gateway workers, platform refill
threads, runtime workers, the janitor). Counters live behind the
``Metrics`` lock; each ``Histogram`` has its own lock; histogram
*creation* is serialized under the ``Metrics`` lock so two racing
``observe`` calls on a brand-new name can never each create a histogram
and drop one of the observations (the old ``defaultdict`` pattern did
exactly that). ``snapshot`` copies the maps under the lock before
rendering, so it never iterates a dict another thread is growing.

Memory contract: a ``Histogram`` is exact while it holds fewer than
``max_samples`` observations and switches to reservoir sampling
(Algorithm R, seeded) above that, so a full-day streaming replay (PR 7)
observing per-request latencies millions of times stays O(max_samples)
per histogram instead of one float per observation forever. ``count``,
``sum``, ``mean``, and the ``count_sum()`` window-edge pair stay EXACT
in reservoir mode (running totals, not reservoir estimates) — the
CalibrationProbe's window deltas depend on that; only the percentile
shape (``percentile``/``snapshot`` p50/p99) becomes a uniform-sample
estimate. ``max_samples=None`` keeps the historical unbounded-exact
behavior; the gateway path constructs its stacks with
``DEFAULT_RESERVOIR``.
"""
from __future__ import annotations

import random
import threading
import time
from collections import defaultdict
from typing import Optional

import numpy as np

# bound used by the live request path (gateway → platform/cluster →
# runtime metrics): big enough that p99 of a replay window is stable
# (~1% resolution needs ~10k samples), small enough that a full-day
# replay's histograms stay a few hundred KB total
DEFAULT_RESERVOIR = 8192


class Histogram:
    def __init__(self, max_samples: Optional[int] = None, seed: int = 0):
        if max_samples is not None and max_samples <= 0:
            raise ValueError(f"max_samples must be positive, got {max_samples}")
        self._vals: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._max_samples = max_samples
        # per-histogram seeded stream: reservoir contents are reproducible
        # for a given observation sequence, independent of global random
        self._rng = random.Random(seed) if max_samples is not None else None
        self._lock = threading.Lock()

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            m = self._max_samples
            if m is None or len(self._vals) < m:
                self._vals.append(v)
            else:
                # Algorithm R: keep each of the _count observations in
                # the reservoir with equal probability m/_count
                j = self._rng.randrange(self._count)
                if j < m:
                    self._vals[j] = v

    def _copy(self) -> list:
        with self._lock:
            return list(self._vals)

    def percentile(self, q) -> float:
        vals = self._copy()
        if not vals:
            return float("nan")
        return float(np.percentile(vals, q))

    @property
    def count(self) -> int:
        """Exact observation count (not the reservoir size)."""
        with self._lock:
            return self._count

    @property
    def mean(self) -> float:
        """Exact running mean (sum/count), even in reservoir mode."""
        with self._lock:
            return self._sum / self._count if self._count else float("nan")

    @property
    def sum(self) -> float:
        """Exact total of all observations (0.0 when empty)."""
        with self._lock:
            return self._sum

    def count_sum(self) -> tuple:
        """One consistent ``(count, sum)`` pair under a single lock
        hold. This is the window-edge primitive: snapshotting the pair
        at two points in time yields the exact mean of the observations
        between them even while writers keep appending — the gateway's
        CalibrationProbe measures replay-window startup costs this way
        (reading ``count`` and ``sum`` as two separate calls could
        straddle a concurrent observe and tear the pair). Both members
        stay exact in reservoir mode."""
        with self._lock:
            return self._count, self._sum

    def snapshot(self) -> dict:
        # one consistent view: count/mean are the exact running totals,
        # percentiles come from the same locked copy of the sample set
        # (the full history below max_samples, a uniform reservoir above)
        with self._lock:
            vals = list(self._vals)
            count, total = self._count, self._sum
        if not vals:
            return {"count": 0, "mean": float("nan"),
                    "p50": float("nan"), "p99": float("nan")}
        arr = np.asarray(vals)
        return {"count": count, "mean": total / count,
                "p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99))}


class Metrics:
    def __init__(self, hist_max_samples: Optional[int] = None):
        # counters stays a defaultdict so read-side code can probe
        # metrics.counters["name"] without guards; all WRITES go through
        # inc() under the lock
        self.counters = defaultdict(int)
        self.hists: dict[str, Histogram] = {}
        self._hist_max = hist_max_samples
        self._lock = threading.Lock()

    def inc(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] += n

    def hist(self, name: str) -> Histogram:
        """The named histogram, created atomically on first use."""
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = Histogram(
                    max_samples=self._hist_max)
            return h

    def observe(self, name: str, v: float):
        self.hist(name).observe(v)

    def timeit(self, name: str):
        metrics = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                self.elapsed = time.perf_counter() - self.t0
                metrics.observe(name, self.elapsed)
        return _Timer()

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            hists = dict(self.hists)
        return {"counters": counters,
                "hists": {k: h.snapshot() for k, h in hists.items()}}
