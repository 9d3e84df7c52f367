"""The serving front door: routing, bounded per-tenant queues, admission
control, SLO timeouts, and worker threads that drive the real stack.

Request path (the live analog of the sim engine's arrival handling)::

    LoadGenerator (open loop, wall clock)
        └─> Gateway.submit(inv)
              ├─ routing: trace fid -> registered function name
              ├─ admission: per-tenant TokenBucket (cgroup CPU-share
              │  analog, reused from core/scheduler.py) — over-rate
              │  tenants are throttled, not queued
              ├─ bounded per-tenant queue (depth = queue_depth;
              │  overflow is rejected, protecting every other tenant)
              └─ notify workers
    worker threads (n_workers)
        ├─ round-robin across tenants (no tenant starves another)
        ├─ SLO gate: a request that waited past slo_timeout_s (in
        │  trace seconds) is dropped, not served late
        ├─ adapter.invoke(...)  — the REAL path: registry lookup,
        │  placement/pool claim, arena acquire, compiled executable
        └─ sleep(duration / compress) — the emulated function body

All times cross between two clocks: *wall* seconds (what
``time.monotonic`` measures while the replay runs) and *trace* seconds
(the timeline the trace was recorded on). ``compress`` trace seconds
pass per wall second, so a trace minute replays in one second at
``compress=60``. Latencies are recorded in trace seconds
(``wall * compress``) so live results are directly comparable with
``core/sim`` output — with the caveat (see docs/benchmarks.md) that
real startup costs do not compress, so they appear amplified by
``compress`` in trace-time units.

This module is a package (``gateway/__init__.py``) rather than ``gateway.py``
so that the documentation's ``gateway/gateway.py`` references keep resolving to
one file (hydralint HL006).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.cluster import AdaptivePoolPolicy, ArrivalRateEstimator
from repro_torch.core.errors import FunctionNotRegisteredError, HydraOOMError
from repro_torch.core.scheduler import TokenBucket
from repro_torch.core.tracing import NULL_TRACE, trace_now


@dataclass
class GatewayParams:
    n_workers: int = 16
    queue_depth: int = 256             # per-tenant bound
    slo_timeout_s: Optional[float] = None   # trace seconds; None disables
    max_wait_s: float = 30.0           # trace seconds before an OOM-retried
                                       # request gives up (sim: max_wait_s)
    retry_backoff_s: float = 0.02      # wall seconds between OOM retries
    tenant_rate: Optional[float] = None     # trace req/s; None disables
    tenant_burst: float = 16.0         # token bucket burst (requests)
    compress: float = 60.0             # trace seconds per wall second


@dataclass
class _Request:
    inv: object                        # the trace Invocation
    name: str                          # registered function name
    sched_wall: float                  # intended (open-loop) arrival
    retries: int = 0
    ctx: object = NULL_TRACE           # RequestTrace when head-sampled
    t_enq: float = 0.0                 # trace_now() at (re-)enqueue


class Gateway:
    """Multi-threaded front door over an adapted serving stack."""

    def __init__(self, adapter, workload, params: GatewayParams,
                 recorder, autoscaler: Optional["Autoscaler"] = None,
                 tracer=None):
        self.adapter = adapter
        self.workload = workload
        self.params = params
        self.recorder = recorder
        self.autoscaler = autoscaler
        # core.tracing.Tracer or None; None keeps the request path on the
        # zero-cost NULL_TRACE everywhere (the measured disabled path)
        self.tracer = tracer
        self._queues: dict[str, deque] = {}
        self._rr: list[str] = []       # tenant round-robin order
        self._rr_next = 0
        self._cv = threading.Condition()
        self._buckets: dict[str, TokenBucket] = {}
        self._in_flight = 0
        self._stop = False
        self._workers: list[threading.Thread] = []

    # ------------------------------------------------------------------
    def start(self) -> None:
        for i in range(self.params.n_workers):
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"gateway-w{i}")
            t.start()
            self._workers.append(t)

    def submit(self, inv, sched_wall: Optional[float] = None) -> bool:
        """Admit one trace invocation. Returns False when the request is
        dropped at the door (unknown function, throttled tenant, or a
        full queue) — every False is recorded with its reason."""
        now = time.monotonic()
        sched_wall = now if sched_wall is None else sched_wall
        name = self.workload.name_for(inv)
        if name is None:
            self.recorder.drop("unknown")
            return False
        tenant = self.workload.tenant_name(inv.tenant)
        # head-sampling decision is made here, once per admitted request;
        # an unsampled request carries the shared no-op NULL_TRACE
        ctx = (self.tracer.start_request(name, tenant)
               if self.tracer is not None else NULL_TRACE)
        # platform adaptive pool sizing sees every arrival, accepted or
        # not: load shed at the door is still load the pool should
        # absorb (cluster targets feed their own per-node estimators
        # inside HydraCluster.invoke instead)
        if self.autoscaler is not None:
            self.autoscaler.observe(now)
        p = self.params
        if p.tenant_rate is not None:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                # trace req/s -> wall req/s at the compression factor
                bucket = self._buckets.setdefault(
                    tenant, TokenBucket(rate=p.tenant_rate * p.compress,
                                        burst=p.tenant_burst))
            if not bucket.try_take():
                self.recorder.drop("throttled")
                ctx.finish("throttled")
                return False
        t_enq = 0.0
        if ctx.sampled:
            # admission covers routing + token bucket up to the enqueue;
            # queue_wait starts from the SAME timestamp so the two spans
            # cannot overlap (conservation invariant)
            t_enq = trace_now()
            ctx.add_span("admission", ctx.t0, t_enq)
        with self._cv:
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._rr.append(tenant)
            if len(q) >= p.queue_depth:
                self.recorder.drop("rejected")
                ctx.finish("rejected")
                return False
            q.append(_Request(inv=inv, name=name, sched_wall=sched_wall,
                              ctx=ctx, t_enq=t_enq))
            self._cv.notify()
        return True

    # ------------------------------------------------------------------
    def _next_request(self) -> Optional[_Request]:
        """Round-robin pop across tenants; caller holds the lock."""
        n = len(self._rr)
        for off in range(n):
            tenant = self._rr[(self._rr_next + off) % n]
            q = self._queues[tenant]
            if q:
                self._rr_next = (self._rr_next + off + 1) % n
                return q.popleft()
        return None

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                req = self._next_request()
                while req is None and not self._stop:
                    self._cv.wait(timeout=0.1)
                    req = self._next_request()
                if req is None:        # stopping and drained
                    return
                self._in_flight += 1
            try:
                self._serve(req)
            finally:
                with self._cv:
                    self._in_flight -= 1
                    self._cv.notify_all()

    def _anomaly(self, kind: str, req: _Request) -> None:
        """Count one anomaly and trigger the flight-recorder dump (the
        last-N sampled traces + a metrics snapshot, JSONL on disk)."""
        if self.tracer is not None:
            self.tracer.anomaly(kind, fid=req.name, ctx=req.ctx)

    def _serve(self, req: _Request) -> None:
        p = self.params
        now = time.monotonic()
        ctx = req.ctx
        if ctx.sampled:
            ctx.add_span("queue_wait", req.t_enq, trace_now())
        waited_trace = (now - req.sched_wall) * p.compress
        if p.slo_timeout_s is not None and waited_trace > p.slo_timeout_s:
            self.recorder.drop("slo_timeout")
            self._anomaly("slo_violation", req)
            ctx.finish("slo_timeout")
            return
        inv = req.inv
        try:
            self.adapter.invoke(req.name, self.workload.args_for(inv),
                                ctx=ctx)
        except (HydraOOMError, FunctionNotRegisteredError) as e:
            # HydraOOM: the fleet is momentarily full (arena budgets
            # saturated by the burst) — back off and requeue, like the
            # sim engine's retry path, until max_wait/SLO expires.
            # FunctionNotRegistered can only be transient here (submit
            # filters unknown fids): the balancer is migrating the
            # function between nodes and the request raced the
            # export->import window — requeue it the same way instead
            # of failing a known function mid-migration.
            if waited_trace > p.max_wait_s:
                self.recorder.drop("gave_up")
                self._anomaly("oom_give_up", req)
                ctx.finish("gave_up")
                return
            req.retries += 1
            self.recorder.retried()
            if isinstance(e, FunctionNotRegisteredError):
                self._anomaly("migration_requeue", req)
            # hydralint: disable=HL002 — deliberate OOM retry backoff on a
            # worker thread, mirrors the sim engine's retry_backoff_s
            time.sleep(p.retry_backoff_s)
            tenant = self.workload.tenant_name(inv.tenant)
            with self._cv:
                if not self._stop:
                    if ctx.sampled:
                        # a fresh queue_wait leg starts at the requeue
                        # (the backoff above stays unattributed)
                        req.t_enq = trace_now()
                    self._queues[tenant].appendleft(req)
                    self._cv.notify()
                else:
                    self.recorder.error(e)
                    ctx.finish("error")
            return
        except Exception as e:
            self.recorder.error(e)
            ctx.finish("error")
            return
        # emulated function body: the trace's duration at compressed
        # wall time (the invoke above covered only the platform path)
        if inv.duration_s > 0:
            with ctx.span("body"):
                # hydralint: disable=HL002 — the emulated function body IS
                # the workload: the trace duration at compressed wall time
                time.sleep(inv.duration_s / p.compress)
        latency_trace = (time.monotonic() - req.sched_wall) * p.compress
        self.recorder.record(latency_trace, inv.duration_s)
        ctx.finish("ok")

    # ------------------------------------------------------------------
    def drain(self, timeout_s: float = 60.0) -> bool:
        """Block until every queued + in-flight request is finished (or
        the timeout passes). Returns True when fully drained."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while (any(self._queues.values()) or self._in_flight > 0):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=min(remaining, 0.25))
        return True

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._workers:
            t.join(timeout=5.0)

    def depth(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._queues.values()) \
                + self._in_flight


# ---------------------------------------------------------------------------
class Autoscaler:
    """Background pool sizing for a single-node ``HydraPlatform``.

    The cluster stack has adaptive pools built in (per-node EWMA
    estimators fed by ``observe_arrival``); a bare platform does not —
    this thread closes that gap with the SAME policy objects
    (``ArrivalRateEstimator`` + ``AdaptivePoolPolicy``): the gateway
    feeds arrivals in wall time, and every ``interval_s`` the estimated
    rate maps to a pool target which drives ``resize_pool``. ``cover_s``
    is in *wall* seconds — runtime boots do not compress, so the pool
    must absorb the arrivals of one real boot window, however fast the
    trace is being replayed.
    """

    def __init__(self, platform, *, pool_min: int = 1, pool_max: int = 8,
                 cover_s: float = 1.0, interval_s: float = 0.25,
                 alpha: float = 0.5):
        self.platform = platform
        self.estimator = ArrivalRateEstimator(alpha=alpha)
        self.policy = AdaptivePoolPolicy(
            pool_min=pool_min, pool_max=pool_max, cover_s=cover_s,
            runtime_bytes=platform.params.runtime_budget_bytes)
        self.interval_s = interval_s
        self.resizes = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def observe(self, now: Optional[float] = None) -> None:
        with self._lock:
            self.estimator.observe(time.monotonic() if now is None else now)

    def tick(self, now: Optional[float] = None) -> int:
        """One sizing decision; returns the chosen pool target."""
        now = time.monotonic() if now is None else now
        with self._lock:
            rate = self.estimator.rate(now)
        target = self.policy.target(rate)
        if target != self.platform.params.pool_size:
            self.platform.resize_pool(target)
            with self._lock:               # HL001: tick() races manual calls
                self.resizes += 1
        return target

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gateway-autoscaler")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
class ClusterBalancer:
    """Burst-time rebalancing for a ``HydraCluster`` target — the cluster
    analog of the platform ``Autoscaler``.

    The cluster already sizes its per-node pools adaptively (EWMA
    estimators inside ``HydraCluster.invoke``), but nothing moves
    *functions* while a replay is running: a tenant-skewed trace packs
    one node solid (colocation) and every burst lands there while the
    other nodes idle. This thread closes that gap: every ``interval_s``
    it reads per-node **committed memory** (placement-estimate bytes, the
    same accounting ``HydraCluster._pick_node`` packs by) and the
    gateway's **queue depth** (the live burst signal), and when the
    commit spread exceeds ``imbalance`` of the per-node budget while
    requests are actually queueing, it triggers
    ``HydraCluster.rebalance()`` — snapshot-migrating the hot node's
    smallest functions onto the coldest node mid-burst.

    Migration needs the snapshot path, so the balancer only arms itself
    when the cluster has a ``snapshot_dir`` (``armed`` reports which).
    Move counts and transfer seconds are read back by the replay
    orchestrator into ``SimResult`` extras, so a live cluster replay and
    the ``hydra-cluster`` sim model diff on migration accounting too.
    """

    def __init__(self, cluster, gateway: Optional[Gateway] = None, *,
                 interval_s: float = 0.25, imbalance: float = 0.25,
                 min_queue: int = 1, max_moves: int = 4):
        self.cluster = cluster
        self.gateway = gateway
        self.interval_s = interval_s
        self.imbalance = imbalance
        self.min_queue = min_queue
        self.max_moves = max_moves
        self.armed = bool(cluster.params.snapshot_dir)
        self.ticks = 0
        self.rebalances = 0            # rebalance() calls that moved >= 1 fn
        self.moves = 0                 # functions migrated
        self.errors = 0
        # HL001: counters are written by the balancer thread and read by
        # the replay orchestrator for SimResult extras
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _spread(self) -> int:
        committed = [n.committed for n in self.cluster.nodes]
        return max(committed) - min(committed) if committed else 0

    def should_rebalance(self) -> bool:
        if not self.armed:
            return False
        if self._spread() <= self.imbalance \
                * self.cluster.params.node_memory_bytes:
            return False
        # only act while the burst is live: an imbalanced-but-idle fleet
        # is a placement-time concern, not worth paying transfer cost for
        if self.gateway is not None \
                and self.gateway.depth() < self.min_queue:
            return False
        return True

    def tick(self) -> int:
        """One balancing decision; returns functions moved this tick."""
        with self._lock:
            self.ticks += 1
        if not self.should_rebalance():
            return 0
        try:
            moved = len(self.cluster.rebalance(max_moves=self.max_moves))
        except Exception:
            # a racing eviction/shutdown must not kill the balancer for
            # the rest of the replay
            with self._lock:
                self.errors += 1
            return 0
        if moved:
            with self._lock:
                self.rebalances += 1
                self.moves += moved
        return moved

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gateway-balancer")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
