"""End-to-end request tracing: spans, phase attribution, flight recorder.

Every request the gateway admits can carry a ``RequestTrace`` context
object down the live stack — ``Gateway._serve`` → adapter →
``HydraPlatform.invoke``/``HydraCluster.invoke`` →
``HydraRuntime._do_invoke`` → ``ArenaPool.acquire`` — collecting one
span per request-path phase. The phase vocabulary is closed (``PHASES``
below is the single registry; hydralint HL008 rejects ad-hoc names) so
aggregated per-phase latency is comparable across PRs and attributable
against the simulator's cost model:

    admission      gateway front door: routing + token bucket + enqueue
    queue_wait     bounded per-tenant queue: enqueue -> worker pickup
    pool_claim     platform pool handover (or inline boot on pool miss)
    register       code install into the claimed runtime (fn_register_s)
    restore        snapshot restore of an evicted function (restore_s)
    arena_acquire  slab claim; ``kind`` attr = reuse | zeroed | cold
    dispatch       runtime work queue: enqueue -> worker dequeue
    compute        compiled executable dispatch + block_until_ready
    body           emulated function body (trace duration, compressed)

The LM serving path (``ContinuousBatcher``) carries the same
``RequestTrace``: ``submit(prompt, max_new, ctx)`` takes the one
``Tracer.start_request`` hands out, and the batcher records that
request's own phases and the time of each token it receives (when the
readback that gave it returns; the first is its first-token time):

    queue_wait     submit -> the start of its own admission (reused name)
    prefill        its own prefill program, slab insert, first readback
    decode         the decode part of each step while it is in flight
    prefill_stall  other requests' admissions inside the steps it waits
                   in for its next token (a long prompt delays the batch)

Beside the request tracks the batcher records the **step track**: one
``step`` span per ``step()``, its children (``admit`` per admission with
``prefill.forward``, ``prefill.insert``, ``readback`` and
``bookkeeping`` inside; ``decode.forward``, ``readback``,
``bookkeeping``) and, inside the forward spans, the model's (``embed``,
``norm``, ``mixer``, ``ffn``, ``lm_head``, ``cache_pack``) and one
``kernel`` span per ``kernels/ops`` entry. Those layers take no
context: ``step_span`` reads the step this thread is running from a
per-thread holder that the batcher sets around ``step()``, so another
thread (another runtime's worker) records nothing into it. Every name
is in the closed ``STEP_SPANS`` vocabulary below; PERF.md §3 names
each span and counter with the metric it feeds. A batcher given a
``Tracer`` records into it. Until the benchmark's serving harness passes
one, a batcher given none records, while a torch profiler records on
its thread, into the process's profile tracer
(``profile_tracer``/``take_profile_tracer``), which the benchmark's
readers take after a traced run; that stopgap goes when the harness
passes a ``Tracer`` (PERF.md §7).

Phases are disjoint intervals inside the request window, so they admit
a conservation invariant: span lengths plus the uncovered gaps
(``unattributed``) equal end-to-end latency exactly, modulo measured
``overlap`` (expected ~0; asserted small by tests and the CI
trace-smoke check). Timestamps all come from ``trace_now``
(``time.perf_counter``) on every thread, so cross-thread spans share
one clock.

Three consumers:

  * **Chrome trace export** (``export_chrome``): one Perfetto-loadable
    JSON (trace-event "X" entries, one track per request, and the step
    track when the tracer holds one) written by ``serve --trace-out``
    (a gateway replay, or the batchers' LM requests and steps);
    ``python -m repro_torch.core.tracing --check spans.json``
    re-validates the schema, the conservation invariant and the step
    track's nesting (CI trace-smoke).
  * **Aggregation** (``summary``/``attribution``): bounded per-phase
    histograms feed the replay extras, the ``CalibrationProbe``
    payload, the ``BENCH_trace.json`` gateway leg, and ``validate
    --attribute`` (which phase drives the live-vs-sim p99/cold delta).
  * **Flight recorder** (``FlightRecorder``): a bounded ring of the
    last N finished traces, dumped as JSONL with a metrics snapshot
    when an anomaly fires (SLO violation, OOM give-up, migration
    requeue) — the triage artifact for "the gate failed, which phase?".

Sampling is head-based and deterministic: request index i is sampled
iff ``mix64(seed, i) / 2^64 < sample_rate``, so a fixed seed replays
the same sampling decisions. The disabled path is near-zero: an
unsampled request carries the shared ``NULL_TRACE`` singleton whose
span methods are no-ops (no allocation, no locking, no clock reads) —
``benchmarks/bench_hotpath.py`` measures and budget-gates exactly that.
A step with no tracer likewise hands out the shared ``_NULL_SPAN`` at
every ``step_span`` site: one per-thread attribute read, nothing more.

This module must stay pure on the hot path (HL002): span bookkeeping
is clock reads + list appends; only the flight-recorder dump — an
anomaly-path action on a request that is already being dropped — does
file I/O, behind a scoped lint disable.

The module is a package (``core/tracing/__init__.py``) rather than
``core/tracing.py`` so that the documentation's bare ``core/tracing.py``
references keep resolving to one file (hydralint HL006); the
module path mirrors ``repro.core.tracing``.
"""
from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.core.metrics import Histogram

# the span-name registry (hydralint HL008 validates every tracer.span()
# call site against the reference's tuple; the LM path's three names
# below are the port's own, held to this one by
# tests/test_torch_lm_tracing.py; PERF.md §3 lists them)
PHASES = (
    "admission",
    "queue_wait",
    "pool_claim",
    "register",
    "restore",
    "arena_acquire",
    "dispatch",
    "compute",
    "body",
    # the LM serving path's own request phases (ContinuousBatcher)
    "prefill",
    "decode",
    "prefill_stall",
)
# the step track's vocabulary (tests/test_torch_lm_tracing.py holds
# every step_span() and StepTrace.child() call site to STEP_SPANS): the
# step's children, then the model's and kernels' spans, which lie
# inside a forward span
STEP_CHILDREN = ("admit", "prefill.forward", "prefill.insert", "readback",
                 "decode.forward", "bookkeeping")
FORWARD_SPANS = ("prefill.forward", "decode.forward")
MODEL_SPANS = ("embed", "norm", "mixer", "ffn", "lm_head", "cache_pack",
               "kernel", "shared")
STEP_SPANS = ("step",) + STEP_CHILDREN + MODEL_SPANS
# the steps a tracer keeps (the newest): ~700 spans each on a 48-layer
# model at two admissions a step; a 50 s window of the benchmark holds
# ~250 steps
MAX_STEPS = 1024
# computed, never emitted by a span call: the uncovered remainder of the
# request window (and the arena_acquire claim-kind splits)
UNATTRIBUTED = "unattributed"
ARENA_KINDS = ("reuse", "zeroed", "cold")
# the fixed aggregation vocabulary (stable key set for BENCH_trace.json)
SUMMARY_KEYS = PHASES + tuple(f"arena_acquire.{k}" for k in ARENA_KINDS) \
    + (UNATTRIBUTED, "total")

CHROME_SCHEMA = "hydra-trace/v1"
FLIGHT_SCHEMA = "hydra-flight/v1"

# one clock for every span on every thread (perf_counter and monotonic
# are the same CLOCK_MONOTONIC on Linux, but mixing them is a latent
# cross-platform conservation bug — all tracing code must use this)
trace_now = time.perf_counter

_M64 = (1 << 64) - 1


def _mix64(seed: int, i: int) -> int:
    """splitmix64 finalizer over (seed, i): a stateless, seekable hash
    so sampling decisions are reproducible per request index."""
    x = ((i + 1) * 0x9E3779B97F4A7C15 + seed * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return x


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


class _NullTrace:
    """Shared no-op request context (the head-sampling 'no' branch and
    the tracer-less gateway both hand this out)."""
    __slots__ = ()
    sampled = False

    def span(self, name: str):
        return _NULL_SPAN

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        pass

    def add_token(self, t: float) -> None:
        pass

    def finish(self, status: str = "ok") -> None:
        pass


_NULL_SPAN = _NullSpan()
NULL_TRACE = _NullTrace()


class Span:
    """One timed phase inside a request; always used as a context
    manager (``with ctx.span("compute") as sp: ... sp.set(kind=...)``).
    Closing appends the record to the owning trace — an exception
    propagates, but the span is still recorded."""
    __slots__ = ("_trace", "name", "attrs", "t0", "t1")

    def __init__(self, trace: "RequestTrace", name: str):
        self._trace = trace
        self.name = name
        self.attrs: Optional[dict] = None
        self.t0 = 0.0
        self.t1 = 0.0

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self.t0 = trace_now()
        return self

    def __exit__(self, *exc):
        self.t1 = trace_now()
        self._trace._append(self.name, self.t0, self.t1, self.attrs)
        return False


@dataclass
class PhaseBreakdown:
    """Per-request phase decomposition with the conservation identity
    ``sum(phases) + unattributed == total + overlap`` (phases are the
    measured span lengths; unattributed is the uncovered remainder of
    the request window; overlap — expected ~0 — is span time counted
    twice by overlapping intervals)."""
    phases: dict                   # name -> seconds, incl. UNATTRIBUTED
    total_s: float
    overlap_s: float

    @classmethod
    def compute(cls, spans: list, total_s: float) -> "PhaseBreakdown":
        phases = {}
        measured = 0.0
        for name, t0, t1, _attrs in spans:
            d = max(0.0, t1 - t0)
            phases[name] = phases.get(name, 0.0) + d
            measured += d
        covered = sum(t1 - t0 for t0, t1 in
                      _interval_union([(t0, t1) for _n, t0, t1, _a in spans]))
        phases[UNATTRIBUTED] = max(0.0, total_s - covered)
        return cls(phases=phases, total_s=total_s,
                   overlap_s=max(0.0, measured - covered))

    def conservation_error_s(self) -> float:
        """|sum(phases) − total − overlap|: ~0 by construction; tests
        assert it stays below epsilon end to end through the export."""
        return abs(sum(self.phases.values()) - self.total_s
                   - self.overlap_s)


def _interval_union(intervals: list) -> list:
    """Disjoint, sorted union of (t0, t1) intervals."""
    out = []
    for t0, t1 in sorted(intervals):
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


class RequestTrace:
    """Span collection for ONE sampled request.

    Threading contract: the request's control flow hands the object
    across threads sequentially (gateway worker → runtime queue →
    runtime worker → back through the Future), so span appends never
    race and need no lock; ``finish`` publishes the completed trace to
    the (locked) tracer exactly once.
    """
    __slots__ = ("tracer", "trace_id", "fid", "tenant", "t0", "spans",
                 "token_times", "status", "total_s", "breakdown",
                 "_finished")

    def __init__(self, tracer: "Tracer", trace_id: int, fid: str,
                 tenant: Optional[str]):
        self.tracer = tracer
        self.trace_id = trace_id
        self.fid = fid
        self.tenant = tenant
        self.t0 = trace_now()
        self.spans: list = []          # (name, t0, t1, attrs|None)
        self.token_times: list = []    # LM path: when each token arrived
        self.status = "open"
        self.total_s = 0.0
        self.breakdown: Optional[PhaseBreakdown] = None
        self._finished = False

    sampled = True

    def span(self, name: str) -> Span:
        return Span(self, name)

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Retroactive span from two already-taken timestamps (used for
        waits measured across threads: queue_wait, dispatch)."""
        self._append(name, t0, t1, attrs or None)

    def _append(self, name, t0, t1, attrs) -> None:
        self.spans.append((name, t0, t1, attrs))

    def add_token(self, t: float) -> None:
        """The time a token of this request reached the host (the LM
        path: when the readback that gave it returned)."""
        self.token_times.append(t)

    def finish(self, status: str = "ok") -> None:
        if self._finished:
            return
        self._finished = True
        self.status = status
        self.total_s = max(0.0, trace_now() - self.t0)
        self.breakdown = PhaseBreakdown.compute(self.spans, self.total_s)
        self.tracer._on_finish(self)

    def to_dict(self) -> dict:
        bd = self.breakdown
        return {
            "trace_id": self.trace_id,
            "fid": self.fid,
            "tenant": self.tenant,
            "t0": self.t0,
            "total_s": self.total_s,
            "status": self.status,
            "spans": [{"name": n, "t0": t0, "t1": t1,
                       **({"attrs": a} if a else {})}
                      for n, t0, t1, a in self.spans],
            "phases": dict(bd.phases) if bd else {},
            "overlap_s": bd.overlap_s if bd else 0.0,
            **({"token_times": list(self.token_times)}
               if self.token_times else {}),
        }


# ---------------------------------------------------------------------------
# The step track (ContinuousBatcher.step and the layers below it)
# ---------------------------------------------------------------------------
_LOCAL = threading.local()


class StepTrace:
    """The spans of one ``ContinuousBatcher.step()``: the step track.

    Used as a context manager around the step, it is this thread's
    current step, which ``step_span`` reads, and on exit it publishes
    its spans to ``tracer`` (none: the spans only time the step's
    request tracks and are dropped). One thread appends, so no lock
    until the publish."""
    __slots__ = ("tracer", "step", "spans", "_prev")

    def __init__(self, tracer: Optional["Tracer"], step: int):
        self.tracer = tracer
        self.step = step
        self.spans: list = []          # (name, t0, t1, attrs|None)
        self._prev = None

    def child(self, name: str, what: Optional[str] = None) -> Span:
        sp = Span(self, name)
        if what is not None:
            sp.attrs = {"name": what}
        return sp

    def _append(self, name, t0, t1, attrs) -> None:
        self.spans.append((name, t0, t1, attrs))

    def __enter__(self) -> "StepTrace":
        self._prev = getattr(_LOCAL, "step", None)
        _LOCAL.step = self
        return self

    def __exit__(self, *exc):
        _LOCAL.step = self._prev
        self._prev = None
        if self.tracer is not None:
            self.tracer._on_step(self.step, self.spans)
        return False


class _NullStepTrace:
    """A step nothing records: every span is the shared no-op one."""
    __slots__ = ()
    tracer = None

    def child(self, name: str, what: Optional[str] = None):
        return _NULL_SPAN

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_STEP = _NullStepTrace()


def step_span(name: str, what: Optional[str] = None):
    """A span of the step this thread runs (``what`` becomes its ``name``
    attribute: a kernel's), or the shared no-op span when none records."""
    st = getattr(_LOCAL, "step", None)
    if st is None:
        return _NULL_SPAN
    return st.child(name, what)


class FlightRecorder:
    """Bounded ring of the last ``ring`` finished traces, dumped as
    JSONL when an anomaly fires. Dumps are capped at ``max_dumps`` per
    replay so an anomaly storm (every request timing out) cannot turn
    the recorder into an unbounded disk writer."""

    def __init__(self, out_dir: str, *, ring: int = 256,
                 max_dumps: int = 8):
        self.out_dir = out_dir
        self.max_dumps = max_dumps
        self._ring: deque = deque(maxlen=ring)
        self._lock = threading.Lock()
        self.dumps = 0
        self.dropped = 0               # anomalies past the dump cap
        os.makedirs(out_dir, exist_ok=True)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def record(self, trace_dict: dict) -> None:
        with self._lock:
            self._ring.append(trace_dict)

    # hydralint: disable=HL002 — anomaly-path file I/O by design: the
    # dump runs for a request that is already being dropped, bounded by
    # max_dumps, never on the steady-state serve path
    def dump(self, kind: str, extra: Optional[dict] = None) -> Optional[str]:
        with self._lock:
            if self.dumps >= self.max_dumps:
                self.dropped += 1
                return None
            self.dumps += 1
            seq = self.dumps
            traces = list(self._ring)
        path = os.path.join(self.out_dir, f"flight-{seq:03d}-{kind}.jsonl")
        header = {"schema": FLIGHT_SCHEMA, "anomaly": kind,
                  "wall_time": time.time(), "n_traces": len(traces),
                  **(extra or {})}
        with open(path, "w") as f:
            f.write(json.dumps(header, default=str) + "\n")
            for tr in traces:
                f.write(json.dumps(tr, default=str) + "\n")
        return path


class Tracer:
    """Thread-safe span collector with deterministic head sampling.

    ``start_request`` is the only hot-path entry: it either hands back
    the shared ``NULL_TRACE`` (unsampled) or a fresh ``RequestTrace``.
    Finished traces are aggregated into bounded per-phase histograms
    and a bounded ``traces`` deque (Chrome export reads the latter, so
    an unbounded replay cannot hold every span in memory — ``dropped``
    counts what the export window lost).
    """

    def __init__(self, sample_rate: float = 1.0, *, seed: int = 0,
                 max_traces: int = 4096,
                 flight: Optional[FlightRecorder] = None,
                 hist_max_samples: int = 8192):
        self.sample_rate = float(sample_rate)
        self.seed = int(seed)
        self.flight = flight
        self._lock = threading.Lock()
        self._index = 0
        self._sampled = 0
        self._finished = 0
        self._dropped = 0
        self._anomalies: dict = {}
        self._done: deque = deque(maxlen=max_traces)
        self._steps: deque = deque(maxlen=MAX_STEPS)   # (step, spans)
        self._hist_max = hist_max_samples
        self._phase_hists: dict = {k: Histogram(max_samples=hist_max_samples)
                                   for k in SUMMARY_KEYS}
        self._overlap_peak_s = 0.0
        self._metrics_cb: Optional[Callable[[], dict]] = None

    # -- hot path ----------------------------------------------------------
    def start_request(self, fid: str, tenant: Optional[str] = None):
        """A ``RequestTrace`` when this request is head-sampled, else
        the shared no-op ``NULL_TRACE``."""
        if self.sample_rate <= 0.0:
            return NULL_TRACE
        with self._lock:
            i = self._index
            take = (self.sample_rate >= 1.0
                    or _mix64(self.seed, i) / 2.0**64 < self.sample_rate)
            self._index += 1
            if take:
                self._sampled += 1
        if not take:
            return NULL_TRACE
        return RequestTrace(self, i, fid, tenant)

    def would_sample(self, index: int) -> bool:
        """The (deterministic) sampling decision for request ``index``
        — exposed so tests can pin head-sampling reproducibility."""
        if self.sample_rate <= 0.0:
            return False
        return (self.sample_rate >= 1.0
                or _mix64(self.seed, index) / 2.0**64 < self.sample_rate)

    def _on_finish(self, trace: RequestTrace) -> None:
        d = trace.to_dict()
        bd = trace.breakdown
        with self._lock:
            self._finished += 1
            if len(self._done) == self._done.maxlen:
                self._dropped += 1
            self._done.append(d)
            self._overlap_peak_s = max(self._overlap_peak_s, bd.overlap_s)
            hists = self._phase_hists
            hists["total"].observe(trace.total_s)
            for name, secs in bd.phases.items():
                h = hists.get(name)
                if h is None:
                    h = hists[name] = Histogram(
                        max_samples=self._hist_max)
                h.observe(secs)
            for name, t0, t1, attrs in trace.spans:
                kind = (attrs or {}).get("kind")
                if name == "arena_acquire" and kind in ARENA_KINDS:
                    hists[f"arena_acquire.{kind}"].observe(max(0.0, t1 - t0))
        fl = self.flight
        if fl is not None:
            fl.record(d)

    def _on_step(self, step: int, spans: list) -> None:
        with self._lock:
            self._steps.append((step, spans))

    # -- anomalies ---------------------------------------------------------
    def set_metrics_provider(self, cb: Callable[[], dict]) -> None:
        """Callback supplying the metrics snapshot embedded in flight
        dumps (the replay wires the adapter's fleet sample in)."""
        with self._lock:
            self._metrics_cb = cb

    def anomaly(self, kind: str, fid: Optional[str] = None,
                ctx=None) -> Optional[str]:
        """Count one anomaly and (when a flight recorder is attached)
        dump the ring + a metrics snapshot. Returns the dump path."""
        with self._lock:
            self._anomalies[kind] = self._anomalies.get(kind, 0) + 1
            cb = self._metrics_cb
        fl = self.flight
        if fl is None:
            return None
        extra: dict = {"fid": fid}
        if ctx is not None and getattr(ctx, "sampled", False):
            extra["trigger"] = ctx.to_dict()
        if cb is not None:
            try:
                extra["metrics"] = cb()
            except Exception as e:   # a racing shutdown must not lose the dump
                extra["metrics_error"] = f"{type(e).__name__}: {e}"
        return fl.dump(kind, extra)

    # -- aggregation -------------------------------------------------------
    def traces(self) -> list:
        with self._lock:
            return list(self._done)

    def steps(self) -> list:
        """The step track: (step id, [(name, t0, t1, attrs|None)]) per
        recorded step, oldest first (the last ``MAX_STEPS`` of them)."""
        with self._lock:
            return list(self._steps)

    def summary(self) -> dict:
        """Fixed-vocabulary aggregate: counts plus per-phase wall-ms
        p50/p99/mean for every ``SUMMARY_KEYS`` entry (None when a
        phase never fired — the key set is stable for the
        ``BENCH_trace.json`` schema gate)."""
        with self._lock:
            hists = dict(self._phase_hists)
            out = {
                "requests": self._index,
                "sampled": self._sampled,
                "finished": self._finished,
                "export_window_dropped": self._dropped,
                "sample_rate": self.sample_rate,
                "anomalies": dict(self._anomalies),
                "overlap_peak_ms": self._overlap_peak_s * 1e3,
            }
        phases = {}
        for name in SUMMARY_KEYS:
            h = hists[name]
            if h.count:
                s = h.snapshot()
                phases[name] = {"count": s["count"],
                                "mean_ms": s["mean"] * 1e3,
                                "p50_ms": s["p50"] * 1e3,
                                "p99_ms": s["p99"] * 1e3}
            else:
                phases[name] = {"count": 0, "mean_ms": None,
                                "p50_ms": None, "p99_ms": None}
        out["phases"] = phases
        if self.flight is not None:
            out["flight"] = {"recorded": len(self.flight),
                             "dumps": self.flight.dumps,
                             "dump_cap_dropped": self.flight.dropped}
        return out

    def attribution(self, tail_q: float = 0.99) -> dict:
        """Which phase dominates the latency tail, and which dominates
        cold requests — the measured answer to "what drives the
        live-vs-sim p99/cold delta" (``validate --attribute``).

        ``body`` is excluded from dominance (the emulated duration is
        modeled identically by the sim; only overhead phases can
        explain a divergence). ``unattributed`` stays in: an untraced
        dominant cost is a finding, not noise.
        """
        traces = self.traces()
        out = {"requests": len(traces)}
        if not traces:
            out["p99"] = out["cold"] = None
            return out
        totals = sorted(t["total_s"] for t in traces)
        thresh = totals[min(len(totals) - 1,
                            int(math.ceil(tail_q * len(totals))) - 1)]
        tail = [t for t in traces if t["total_s"] >= thresh]
        cold = [t for t in traces if _is_cold(t)]
        out["p99"] = _attribute_group(tail, {"threshold_s": thresh})
        out["cold"] = _attribute_group(cold, {})
        return out


def _is_cold(trace_dict: dict) -> bool:
    """A request that paid any cold-path cost: a cold slab mint, a
    pool-miss inline boot, a code install, or a snapshot restore."""
    for sp in trace_dict["spans"]:
        name = sp["name"]
        attrs = sp.get("attrs") or {}
        if name == "arena_acquire" and attrs.get("kind") == "cold":
            return True
        if name == "pool_claim" and attrs.get("source") == "boot":
            return True
        if name in ("register", "restore"):
            return True
    return False


def _attribute_group(traces: list, base: dict) -> Optional[dict]:
    if not traces:
        return None
    sums: dict = {}
    for t in traces:
        for name, secs in t["phases"].items():
            sums[name] = sums.get(name, 0.0) + secs
    n = len(traces)
    means = {name: (s / n) * 1e3 for name, s in sums.items()}
    candidates = {k: v for k, v in means.items() if k != "body"}
    dominant = max(candidates, key=candidates.get) if candidates else None
    return {**base, "n": n, "phase_mean_ms": means, "dominant": dominant}


class _ProfileTracer:
    """The process's tracer for profiled stretches: what a batcher given
    no tracer records into while a torch profiler records on its thread,
    kept until a reader takes it. A stopgap for the benchmark, whose
    serving harness passes no ``Tracer`` yet: it goes, with the
    scheduler's ``_profiled`` branches, once the harness passes one."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tracer: Optional[Tracer] = None

    def get(self) -> Tracer:
        with self._lock:
            if self._tracer is None:
                self._tracer = Tracer()
            return self._tracer

    def take(self) -> Optional[Tracer]:
        with self._lock:
            tracer, self._tracer = self._tracer, None
            return tracer


_PROFILED = _ProfileTracer()
profile_tracer = _PROFILED.get
take_profile_tracer = _PROFILED.take


# ---------------------------------------------------------------------------
# Chrome trace-event export + validation (Perfetto-loadable)
# ---------------------------------------------------------------------------

def chrome_trace(traces: list, meta: Optional[dict] = None,
                 steps: list = ()) -> dict:
    """Chrome trace-event JSON from ``Tracer.traces()`` output: one
    complete ("X") event per request on its own track (tid =
    trace_id), one per span, and explicit ``unattributed`` events for
    the uncovered gaps — so the events of a track sum to the request's
    end-to-end duration (the conservation invariant ``--check``
    re-verifies). ``steps`` (``Tracer.steps()``) adds the step track:
    its spans on a process of their own (pid 2), category ``step``,
    each with its step id."""
    events = []
    t_base = min([t["t0"] for t in traces]
                 + [sp[1] for _, sps in steps for sp in sps], default=0.0)

    def us(t: float) -> float:
        return (t - t_base) * 1e6

    for t in traces:
        tid = t["trace_id"]
        args = {"trace_id": tid, "fid": t["fid"], "tenant": t["tenant"],
                "status": t["status"], "overlap_ms": t["overlap_s"] * 1e3}
        if t.get("token_times"):
            args["token_ms"] = [(x - t["t0"]) * 1e3
                                for x in t["token_times"]]
        events.append({
            "name": "request", "cat": "request", "ph": "X",
            "ts": us(t["t0"]), "dur": t["total_s"] * 1e6,
            "pid": 1, "tid": tid, "args": args,
        })
        intervals = []
        for sp in t["spans"]:
            intervals.append((sp["t0"], sp["t1"]))
            events.append({
                "name": sp["name"], "cat": "phase", "ph": "X",
                "ts": us(sp["t0"]),
                "dur": max(0.0, sp["t1"] - sp["t0"]) * 1e6,
                "pid": 1, "tid": tid,
                "args": sp.get("attrs") or {},
            })
        cur = t["t0"]
        t_end = t["t0"] + t["total_s"]
        for s0, s1 in _interval_union(intervals):
            s0, s1 = max(s0, cur), min(s1, t_end)
            if s0 > cur:
                events.append({"name": UNATTRIBUTED, "cat": "phase",
                               "ph": "X", "ts": us(cur),
                               "dur": (s0 - cur) * 1e6,
                               "pid": 1, "tid": tid, "args": {}})
            cur = max(cur, s1)
        if t_end > cur:
            events.append({"name": UNATTRIBUTED, "cat": "phase", "ph": "X",
                           "ts": us(cur), "dur": (t_end - cur) * 1e6,
                           "pid": 1, "tid": tid, "args": {}})
    for step, sps in steps:
        for name, s0, s1, attrs in sps:
            events.append({"name": name, "cat": "step", "ph": "X",
                           "ts": us(s0), "dur": max(0.0, s1 - s0) * 1e6,
                           "pid": 2, "tid": 0,
                           "args": {**(attrs or {}), "step": step}})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"schema": CHROME_SCHEMA, "phases": list(PHASES),
                      "step_spans": list(STEP_SPANS), **(meta or {})},
    }


def export_chrome(tracer: Tracer, path: str,
                  meta: Optional[dict] = None) -> dict:
    doc = chrome_trace(tracer.traces(), meta=meta, steps=tracer.steps())
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return doc


def _step_track_errors(evs: list) -> list:
    """Nesting of the step track: every span inside a ``step``, every
    model or kernel span inside a forward span (one thread, one clock:
    exact up to the microsecond rounding of the export)."""
    eps = 1.0

    def enclosures(names):
        ivs = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs
                     if e["name"] in names)
        return [a for a, _ in ivs], ivs

    def inside(encl, e) -> bool:
        starts, ivs = encl
        i = bisect.bisect_right(starts, e["ts"] + eps) - 1
        return i >= 0 and ivs[i][1] >= e["ts"] + e["dur"] - eps

    steps, fwd = enclosures(("step",)), enclosures(FORWARD_SPANS)
    errors = []
    for e in evs:
        if e["name"] != "step" and not inside(steps, e):
            errors.append(f"step track: {e['name']} at {e['ts']:.0f}us "
                          f"lies in no step span")
        elif e["name"] in MODEL_SPANS and not inside(fwd, e):
            errors.append(f"step track: {e['name']} at {e['ts']:.0f}us "
                          f"lies in no forward span")
    return errors


def validate_chrome(doc: Any, epsilon_ms: float = 2.0) -> list:
    """Schema + conservation errors for an exported span file (empty
    list = valid). Checks the trace-event shape Perfetto requires and,
    per request track, that phase events sum to the request's duration
    within ``epsilon_ms`` plus 1% (clock-read jitter scales with the
    number of spans, never with the request length)."""
    errors: list = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["not a trace-event document (traceEvents list missing)"]
    known = set(PHASES) | {UNATTRIBUTED, "request"}
    by_tid: dict = {}
    step_evs: list = []
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        for field_name in ("name", "ph", "ts", "dur", "pid", "tid"):
            if field_name not in ev:
                errors.append(f"event {i}: missing {field_name!r}")
        if ev.get("ph") != "X":
            errors.append(f"event {i}: ph={ev.get('ph')!r} (expected "
                          f"complete 'X' events)")
            continue
        if not isinstance(ev.get("ts"), (int, float)) \
                or not isinstance(ev.get("dur"), (int, float)) \
                or ev.get("dur", 0) < 0 \
                or not math.isfinite(ev.get("ts", 0.0)) \
                or not math.isfinite(ev.get("dur", 0.0)):
            errors.append(f"event {i} ({ev.get('name')}): bad ts/dur")
            continue
        if ev.get("cat") == "step":
            if ev.get("name") in STEP_SPANS:
                step_evs.append(ev)
            else:
                errors.append(f"event {i}: unknown step span "
                              f"{ev.get('name')!r} (registry: "
                              f"{list(STEP_SPANS)})")
            continue
        if ev.get("name") not in known:
            errors.append(f"event {i}: unknown span name "
                          f"{ev.get('name')!r} (registry: {sorted(known)})")
            continue
        by_tid.setdefault(ev.get("tid"), []).append(ev)
    for tid, evs in sorted(by_tid.items(), key=lambda kv: str(kv[0])):
        reqs = [e for e in evs if e["name"] == "request"]
        if len(reqs) != 1:
            errors.append(f"track {tid}: {len(reqs)} request events "
                          f"(expected exactly 1)")
            continue
        req = reqs[0]
        total_us = req["dur"]
        phase_us = sum(e["dur"] for e in evs if e["name"] != "request")
        eps_us = epsilon_ms * 1e3 + 0.01 * total_us
        if abs(phase_us - total_us) > eps_us:
            errors.append(
                f"track {tid}: conservation violated — phases sum to "
                f"{phase_us:.0f}us vs request {total_us:.0f}us "
                f"(epsilon {eps_us:.0f}us)")
        for e in evs:
            if e["name"] == "request":
                continue
            if e["ts"] < req["ts"] - eps_us \
                    or e["ts"] + e["dur"] > req["ts"] + total_us + eps_us:
                errors.append(f"track {tid}: span {e['name']} outside "
                              f"the request window")
    errors.extend(_step_track_errors(step_evs))
    if not by_tid:
        errors.append("no request tracks (empty trace)")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate an exported Chrome trace-event span file "
                    "(serve --trace-out): Perfetto-loadable schema, the "
                    "per-request phase-conservation invariant and the "
                    "step track's nesting. Exits 1 on any violation.")
    ap.add_argument("--check", metavar="PATH", required=True,
                    help="spans JSON to validate (Chrome trace-event "
                         "format as written by --trace-out)")
    ap.add_argument("--epsilon-ms", type=float, default=2.0,
                    help="absolute conservation tolerance per request "
                         "(plus 1%% of the request duration)")
    args = ap.parse_args(argv)
    try:
        with open(args.check) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"tracing: cannot read {args.check}: {e}", file=sys.stderr)
        return 2
    errors = validate_chrome(doc, epsilon_ms=args.epsilon_ms)
    for e in errors:
        print(f"# FAIL {e}", file=sys.stderr)
    if errors:
        return 1
    n = len({ev.get("tid") for ev in doc["traceEvents"]
             if ev.get("cat") != "step"})
    n_steps = sum(ev.get("cat") == "step" and ev.get("name") == "step"
                  for ev in doc["traceEvents"])
    print(f"tracing: {args.check} OK — {n} request tracks, {n_steps} "
          f"steps, {len(doc['traceEvents'])} events, conservation within "
          f"{args.epsilon_ms:g}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
