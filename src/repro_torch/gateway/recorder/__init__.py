"""Live-replay recording in the simulator's result schema.

The whole point of the gateway is a closed loop with ``core/sim``: a
live replay must come back in the exact shape a simulated replay does,
so the two are diffable metric-by-metric (``gateway/validate.py``).
``Recorder.finish`` therefore returns a real
:class:`repro_torch.core.sim.engine.SimResult` — not a look-alike — with:

  * ``latencies``/``overheads`` recorded per served request in *trace*
    seconds (wall seconds x the compression factor);
  * ``mem_samples``/``pool_mem_samples``/``runtime_count_samples``
    gathered by a background sampler thread on a fixed wall-clock grid
    (timestamps converted to trace time), using the adapters' budget +
    per-runtime-base accounting;
  * cold/warm/pool/evicted counters read from the live platform metrics
    through the adapter at finish time.

Everything the sim has no vocabulary for — drop reasons, invoke
errors, wall-clock duration — is returned separately by ``extras()``.

``CalibrationProbe`` rides the same sampler: it baselines the stack's
startup-cost histograms when the replay clock starts, samples process
RSS and per-node memory on the recorder's grid, and at finish reports
replay-window wall-second means for every cost the simulator can be
calibrated with (``core.calibrate.calibration_from_replay`` turns that
payload into a ``hydra-calibration/v1`` overlay).

Process RSS is host memory: device memory (the arenas and weights on
the card) is not in it, so the probe's memory readings go to the
calibration's ``meta`` only, as in the reference.

This module is a package (``recorder/__init__.py``) rather than ``recorder.py``
so that the documentation's ``gateway/recorder.py`` references keep resolving to
one file (hydralint HL006).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

from repro_torch.core.sim.engine import SimResult


def _process_rss_bytes() -> Optional[int]:
    """Resident set size of this process, or None when unmeasurable.
    The getrusage fallback reports *peak* RSS (the best a non-/proc
    platform offers — a monotone upper bound, not a series); ru_maxrss
    is kilobytes everywhere except Darwin, where it is already bytes."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError, AttributeError):
        pass
    try:
        import resource
        import sys
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024
    except Exception:
        return None


class CalibrationProbe:
    """Measure what one live replay can teach the simulator.

    Three measurement families, all scoped to the replay window (costs
    incurred while *building* the stack — prewarm boots, up-front
    registrations — are baselined out):

      * **startup/warm/restore costs** — window deltas of the stack's
        own timing histograms: ``runtime_boot_s`` (cold boots + pool
        re-warms), ``pool_claim_s`` (warm handovers), ``restore_s``
        (snapshot restores) on each node's platform metrics, and
        ``register_s`` (request-path code installs) plus
        ``arena.alloc_s`` (cold isolate/arena allocations) on
        per-runtime metrics. Means are in wall seconds; the calibration
        layer scales them by ``compress`` into trace time. Window
        scoping matters doubly for ``arena.alloc_s``: pre-replay
        allocations (and their one-time warmup) are baselined out, so
        the mean is the steady-state cold-acquire cost the sim's
        ``isolate_cold_s`` models.
      * **process RSS** — sampled on the recorder grid; the *marginal*
        per-runtime figure (window RSS growth over window runtime-count
        growth) is reported, and only applied to the sim's
        ``hydra_runtime_base`` when explicitly requested (see
        ``calibration_from_replay``).
      * **per-node memory** — the adapter's per-node committed-byte
        series, so a cluster replay exposes each node's footprint, not
        just the fleet sum.

    Per-runtime metrics objects die with their runtime (drained
    runtimes shut down); their in-window observations are lost, which
    under-samples but never skews the surviving means.
    """

    PLATFORM_COSTS = ("runtime_boot_s", "pool_claim_s", "restore_s")
    RUNTIME_COSTS = ("register_s", "arena.alloc_s")

    def __init__(self, adapter, *, compress: float, tracer=None):
        self.adapter = adapter
        self.compress = compress
        # optional core.tracing.Tracer: its per-phase aggregates ride in
        # the probe payload so calibration reports carry the span-level
        # decomposition next to the histogram-window costs
        self.tracer = tracer
        self._lock = threading.Lock()
        # keyed by the Metrics OBJECT (strong ref, identity hash): an
        # id()-keyed map would let a dead runtime's address be reused by
        # a new Metrics object and its stale baseline corrupt the window
        self._baseline: dict = {}       # Metrics -> {name: (count, sum)}
        self._rss0: Optional[int] = None
        self._runtimes0 = 0             # fleet runtime count at begin()
        self._rss: list = []            # (t_trace, rss_bytes)
        self._per_runtime: list = []    # rss growth / runtime growth
        self._node_peaks: list = []     # per-node committed peak

    def _hist_state(self, metrics, names) -> dict:
        out = {}
        for name in names:
            h = metrics.hists.get(name)
            if h is not None:
                out[name] = h.count_sum()     # one atomic pair
        return out

    def begin(self) -> None:
        """Snapshot histogram state at replay start; window deltas are
        measured against this.  The snapshot is taken into locals first
        so a failing adapter probe cannot leave the baseline half
        written (HL010)."""
        baseline = {}
        for m in self.adapter.platform_metrics():
            baseline[m] = self._hist_state(m, self.PLATFORM_COSTS)
        for m in self.adapter.runtime_metrics():
            baseline[m] = self._hist_state(m, self.RUNTIME_COSTS)
        rss0 = _process_rss_bytes()
        runtimes0 = self.adapter.sample().get("runtimes", 0)
        n_nodes = self.adapter.n_nodes
        with self._lock:
            self._baseline.clear()
            self._baseline.update(baseline)
            self._rss0 = rss0
            self._runtimes0 = runtimes0
            self._rss.clear()
            self._per_runtime.clear()
            self._node_peaks = [0] * n_nodes

    def sample(self, t_trace: float, fleet: dict) -> None:
        """One grid sample (called from the recorder's sampler thread
        with the fleet sample it already took — the per-node series
        rides in it, so nothing is recomputed on the hot path)."""
        rss = _process_rss_bytes()
        node_mem = fleet.get("node_mem_bytes") or self.adapter.node_mem()
        with self._lock:
            if rss is not None:
                self._rss.append((t_trace, rss))
                # marginal RSS per runtime: the replay window's RSS
                # growth over its runtime-count growth — dividing by the
                # TOTAL count would let baseline (prewarmed) runtimes
                # dilute the estimate toward zero
                grown = fleet.get("runtimes", 0) - self._runtimes0
                if self._rss0 is not None and grown > 0:
                    self._per_runtime.append(
                        max(0, rss - self._rss0) / grown)
            if len(node_mem) != len(self._node_peaks):
                self._node_peaks = [0] * len(node_mem)
            for i, m in enumerate(node_mem):
                self._node_peaks[i] = max(self._node_peaks[i], m)

    def _window_costs(self) -> dict:
        """Replay-window (count, sum) per cost name, across all live
        metrics objects; objects born during the replay have no baseline
        and count in full."""
        totals: dict = {}
        for metrics, names in (
                [(m, self.PLATFORM_COSTS)
                 for m in self.adapter.platform_metrics()]
                + [(m, self.RUNTIME_COSTS)
                   for m in self.adapter.runtime_metrics()]):
            base = self._baseline.get(metrics, {})
            for name in names:
                h = metrics.hists.get(name)
                if h is None:
                    continue
                b_count, b_sum = base.get(name, (0, 0.0))
                n_count, n_sum = h.count_sum()
                d_count = n_count - b_count
                d_sum = n_sum - b_sum
                if d_count > 0 and d_sum >= 0:
                    c, s = totals.get(name, (0, 0.0))
                    totals[name] = (c + d_count, s + d_sum)
        return totals

    def finish(self) -> dict:
        """The probe payload ``calibration_from_replay`` consumes
        (recorded under ``extras['probe']`` by ``replay_trace``)."""
        with self._lock:
            rss = list(self._rss)
            per_runtime = list(self._per_runtime)
            peaks = list(self._node_peaks)
            rss0 = self._rss0
            # HL001: _window_costs reads the _baseline snapshot that
            # begin() populates under this lock
            costs = {name: {"count": c, "sum": s, "mean": s / c}
                     for name, (c, s) in self._window_costs().items()}
        rss_vals = [b for _, b in rss]
        out = {
            "compress": self.compress,
            "wall_costs": costs,
            "rss": {
                "start_bytes": rss0,
                "peak_bytes": max(rss_vals) if rss_vals else None,
                "mean_bytes": (sum(rss_vals) / len(rss_vals)
                               if rss_vals else None),
                "per_runtime_bytes": (sum(per_runtime) / len(per_runtime)
                                      if per_runtime else None),
                "samples": len(rss),
            },
            "node_mem_peak_bytes": peaks,
        }
        if self.tracer is not None:
            # span-level wall-ms decomposition alongside the
            # histogram-window costs (consumed by validate --attribute)
            out["phases"] = self.tracer.summary()["phases"]
        return out


class Recorder:
    def __init__(self, adapter, *, compress: float,
                 sample_dt_s: float = 0.25,
                 probe: Optional[CalibrationProbe] = None,
                 tracer=None):
        self.adapter = adapter
        self.compress = compress
        self.sample_dt_s = sample_dt_s
        self.probe = probe
        self.tracer = tracer           # core.tracing.Tracer or None
        self._lock = threading.Lock()
        self._latencies: list = []
        self._overheads: list = []
        self._drops: dict[str, int] = {}
        self._retries = 0
        self._sample_failures = 0
        self._errors: list = []
        self._mem: list = []
        self._pool: list = []
        self._counts: list = []
        self._peak_pool = 0
        # isolate counters can shrink when a drained runtime shuts down
        # (its Metrics object goes with it); keep the max observed
        self._iso_peak = (0, 0)
        self._t0: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- request accounting -------------------------------------------------
    def record(self, latency_trace_s: float, duration_s: float) -> None:
        with self._lock:
            self._latencies.append(latency_trace_s)
            self._overheads.append(latency_trace_s - duration_s)

    def drop(self, reason: str) -> None:
        with self._lock:
            self._drops[reason] = self._drops.get(reason, 0) + 1

    def retried(self) -> None:
        with self._lock:
            self._retries += 1

    def error(self, exc: Exception) -> None:
        with self._lock:
            if len(self._errors) < 32:       # keep a bounded sample
                self._errors.append(f"{type(exc).__name__}: {exc}")
            self._drops["error"] = self._drops.get("error", 0) + 1

    # -- fleet sampling -----------------------------------------------------
    def start(self, t0_wall: float) -> None:
        self._t0 = t0_wall
        if self.probe is not None:
            self.probe.begin()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gateway-recorder")
        self._thread.start()

    def _sample_once(self) -> None:
        s = self.adapter.sample()
        t_trace = (time.monotonic() - self._t0) * self.compress
        iso = self.adapter._isolate_counts()
        if self.probe is not None:
            self.probe.sample(t_trace, s)
        with self._lock:
            self._mem.append((t_trace, s["mem_bytes"]))
            self._pool.append((t_trace, s["pool_bytes"]))
            self._counts.append((t_trace, s["runtimes"]))
            self._peak_pool = max(self._peak_pool, s["pool_bytes"])
            self._iso_peak = (max(self._iso_peak[0], iso[0]),
                              max(self._iso_peak[1], iso[1]))

    def _loop(self) -> None:
        failures = 0
        while not self._stop.wait(self.sample_dt_s):
            try:
                self._sample_once()
                failures = 0
            except Exception:
                # a transient race (e.g. an autoscaler resize shutting a
                # runtime down mid-sample) must not kill sampling for the
                # rest of the replay — and is NOT a request-level drop;
                # only persistent failure stops the thread
                with self._lock:
                    self._sample_failures += 1
                failures += 1
                if failures >= 5:
                    return

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        try:
            self._sample_once()               # closing sample
        except Exception:
            pass

    # -- result -------------------------------------------------------------
    def finish(self, n_nodes: Optional[int] = None) -> SimResult:
        """The live replay as a real ``SimResult``. ``n_nodes`` defaults
        to the adapter's REAL machine count — a cluster replay stamped
        as one node would read N-fold denser than the simulator's
        fleet-wide accounting of the same trace."""
        if n_nodes is None:
            n_nodes = self.adapter.n_nodes
        c = self.adapter.counters()
        with self._lock:
            # HL001: _iso_peak is maintained by the sampler thread
            iso_cold = max(self._iso_peak[0], c["cold_isolate"])
            iso_warm = max(self._iso_peak[1], c["warm_isolate"])
            res = SimResult(
                model=f"live-{self.adapter.kind}",
                latencies=list(self._latencies),
                overheads=list(self._overheads),
                mem_samples=list(self._mem),
                pool_mem_samples=list(self._pool),
                runtime_count_samples=list(self._counts),
                cold_runtime_starts=c["cold_runtime"],
                cold_isolate_starts=iso_cold,
                warm_isolate_starts=iso_warm,
                evicted_runtimes=c["evicted_runtimes"],
                dropped=sum(self._drops.values()),
                pool_claims=c["pool_claims"],
                transfers=c["transfers"],
                peak_pool_mem=self._peak_pool,
                n_nodes=n_nodes,
            )
        return res

    def request_overhead_ms(self) -> dict:
        """Per-request overhead (latency − emulated duration) in WALL
        milliseconds — the request-path cost the gateway itself adds:
        registry lookup, slab claim, dispatch, release. Overheads are
        recorded in trace seconds, so wall ms = trace_s / compress × 1e3.
        This is the number the overhead budget gates on
        (``benchmarks/bench_hotpath.py`` measures the same path without a
        trace)."""
        with self._lock:
            ovh = sorted(self._overheads)
        n = len(ovh)
        if n == 0:
            return {"count": 0, "mean": None, "p99": None}
        to_ms = 1e3 / self.compress
        p99 = ovh[min(n - 1, int(round(0.99 * (n - 1))))]
        return {"count": n,
                "mean": (sum(ovh) / n) * to_ms,
                "p99": p99 * to_ms}

    def extras(self) -> dict:
        overhead = self.request_overhead_ms()
        exe = self.adapter.exe_stats()
        slab = self.adapter.slab_counts()
        with self._lock:
            out = {"drops": dict(self._drops),
                   "retries": self._retries,
                   "sample_failures": self._sample_failures,
                   "errors": list(self._errors),
                   "request_overhead_ms": overhead,
                   "exe_cache": exe,
                   "slab": slab}
        if self.tracer is not None:
            out["tracing"] = self.tracer.summary()
        return out
