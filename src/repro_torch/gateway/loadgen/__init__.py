"""Open-loop load generation: the trace's arrival process on the wall
clock.

Closed-loop drivers (like the synthetic loop in ``launch/serve.py``)
submit the next request when the previous one finishes, so a slow
platform quietly sees *less* load — exactly the feedback that hides
cold-start pain. The ``LoadGenerator`` is open loop: every invocation
is submitted at its trace timestamp (divided by ``compress``) whether
or not earlier requests completed; queueing, throttling, and SLO
misses then land in the gateway where they belong.

If the generator itself falls behind (the submit path stalled longer
than the gap to the next arrival), the invocation is submitted
immediately but keeps its *intended* schedule time, so the lag is
charged to measured latency rather than silently re-timing the trace;
``LoadResult.late``/``max_lag_s`` report how often that happened.

At high ``--compress`` a single submit loop becomes the bottleneck (one
thread sleeping-and-submitting caps the achievable arrival rate), so
``ShardedLoadGenerator`` partitions the trace by tenant
(``tenant % n_shards``) and replays every shard on its own thread
against the same wall ``t0``: the absolute timeline is preserved, each
tenant's arrivals stay FIFO inside one shard, and the shard union is
exactly the unsharded trace. ``Gateway.submit`` is thread-safe, so the
shards need no coordination beyond the shared clock.

This module is a package (``loadgen/__init__.py``) rather than ``loadgen.py``
so that the documentation's bare ``loadgen.py`` references keep resolving to
one file (hydralint HL006).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

# a submit later than this (wall seconds) counts as "late" — small
# scheduler jitter below it is noise, not lag
LATE_SLACK_S = 0.010


@dataclass
class LoadResult:
    submitted: int = 0
    accepted: int = 0
    late: int = 0
    max_lag_s: float = 0.0        # worst wall-clock lag behind schedule
    wall_s: float = 0.0           # generator wall-clock run time


class LoadGenerator:
    def __init__(self, trace, gateway, compress: float = 60.0):
        self.trace = trace
        self.gateway = gateway
        self.compress = compress

    def run(self, t0_wall: Optional[float] = None) -> LoadResult:
        """Replay the whole trace; blocks until the last submit."""
        t0 = time.monotonic() if t0_wall is None else t0_wall
        res = LoadResult()
        for inv in self.trace:
            target = t0 + inv.t / self.compress
            now = time.monotonic()
            if target > now:
                time.sleep(target - now)
            else:
                lag = now - target
                if lag > LATE_SLACK_S:
                    res.late += 1
                    res.max_lag_s = max(res.max_lag_s, lag)
            res.submitted += 1
            if self.gateway.submit(inv, sched_wall=target):
                res.accepted += 1
        res.wall_s = time.monotonic() - t0
        return res


def shard_trace(trace, n_shards: int, shard_index: int):
    """The tenant partition ``tenant % n_shards == shard_index`` of
    ``trace``. A trace with native sharding (``StreamingTrace.shard``)
    stays lazy; anything else is filtered into a list. The n partitions
    are disjoint and their union is the whole trace."""
    if n_shards <= 1:
        return trace
    native = getattr(trace, "shard", None)
    if callable(native):
        return native(n_shards, shard_index)
    return [inv for inv in trace if inv.tenant % n_shards == shard_index]


class ShardedLoadGenerator:
    """N per-tenant-shard :class:`LoadGenerator` threads sharing one wall
    ``t0``. ``run`` blocks until every shard finishes and returns the
    merged :class:`LoadResult` (counts summed, lags maxed)."""

    def __init__(self, trace, gateway, compress: float = 60.0,
                 n_shards: int = 2):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.gens = [
            LoadGenerator(shard_trace(trace, n_shards, i), gateway, compress)
            for i in range(n_shards)]

    def run(self, t0_wall: Optional[float] = None) -> LoadResult:
        t0 = time.monotonic() if t0_wall is None else t0_wall
        results: list = [None] * len(self.gens)
        errors: list = []

        def drive(i, gen):
            try:
                results[i] = gen.run(t0)
            except BaseException as e:       # surfaced to the caller below
                errors.append(e)

        threads = [threading.Thread(target=drive, args=(i, g),
                                    name=f"loadgen-shard-{i}", daemon=True)
                   for i, g in enumerate(self.gens)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        merged = LoadResult()
        for r in results:
            merged.submitted += r.submitted
            merged.accepted += r.accepted
            merged.late += r.late
            merged.max_lag_s = max(merged.max_lag_s, r.max_lag_s)
            merged.wall_s = max(merged.wall_s, r.wall_s)
        return merged
