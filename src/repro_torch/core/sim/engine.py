"""Model-agnostic discrete-event simulation engine.

The engine owns the *mechanics* every platform model shares: the event
heap, per-node memory accounting, metric sampling on a fixed grid,
queueing with retry/backoff and give-up, idle-runtime reclaim under
memory pressure, warm-pool refill, isolate-TTL eviction, keep-alive
expiry, and drain-to-pool of emptied runtimes. Every *policy* decision —
how invocations group into runtimes, where a new runtime boots, what a
startup costs, how warm pools resize — lives in a
:class:`~repro_torch.core.sim.models.PlatformModel` subclass; the engine calls
its hooks and never branches on a model name.

``simulate`` / ``compare`` / ``simulate_partitioned`` (the public entry
points that resolve a model name through the ``MODELS`` registry) live in
``repro_torch.core.sim`` (the package ``__init__``);
``repro_torch.core.tracesim`` re-exports everything for back-compat.

A copy of ``repro.core.sim.engine`` with its imports rewritten.
"""
from __future__ import annotations

import heapq
from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

MB = 1 << 20
GB = 1 << 30


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SimParams:
    # startup costs (seconds) — paper Fig 1/8 scale; override with values
    # measured on your host via ``repro_torch.core.calibrate`` (bench_startup
    # --emit-calibration)
    runtime_cold_s: float = 0.150      # native runtime boot (cold start)
    hydra_runtime_cold_s: float = 0.046  # AOT-compiled runtime boot (2-3x faster)
    isolate_cold_s: float = 0.0005     # isolate/arena allocation (<500 us)
    isolate_warm_s: float = 0.00005    # pool hit
    fn_register_s: float = 0.010       # per-function code install (hydra)
    # memory model (bytes)
    runtime_base: int = 30 * MB        # native runtime RSS
    hydra_runtime_base: int = 46 * MB  # polyglot runtime RSS (paper Fig 5)
    isolate_base: int = 1 * MB         # pre-allocated isolate heap
    runtime_cap: int = 2 * GB          # per-runtime budget (hydra/photons)
    machine_cap: int = 16 * GB         # FLEET budget (paper: 16 GB segment)
    keepalive_s: float = 60.0          # worker keep-alive (openwhisk)
    isolate_ttl_s: float = 10.0        # isolate pool TTL
    vm_boot_s: float = 0.125           # Firecracker microVM boot
    retry_backoff_s: float = 0.05      # queue retry when machine is full
    max_wait_s: float = 30.0           # give up queueing after this
    # platform layer (hydra-pool / hydra-cluster models)
    pool_size: int = 4                 # pre-warmed instances (fixed policy)
    pool_claim_s: float = 0.002        # claim a warm instance from the pool
    pool_refill_s: float = 1.0         # background re-warm after a claim
    snapshot_restore_s: float = 0.004  # install a snapshotted fn (vs
                                       # fn_register_s for a first install)
    pool_drain_ttl_s: float = 10.0     # an idle (empty) platform runtime
                                       # drains back to the warm pool after
                                       # this, like HydraPlatform's
                                       # _return_runtime (0 disables)
    # multi-node fleet (hydra-cluster model only)
    n_nodes: int = 4                   # machines in the cluster
    node_cap: Optional[int] = None     # per-node memory; default splits
                                       # machine_cap evenly (fleet total
                                       # stays constant across node counts)
    transfer_gbps: float = 10.0        # cross-node snapshot bandwidth
    snapshot_bytes: int = 24 * MB      # serialized sandbox snapshot size
    adaptive_pool: bool = True         # EWMA-driven per-node pool sizing
    pool_min: int = 2                  # adaptive pool floor (per node)
    pool_max: Optional[int] = None     # adaptive ceiling; default pool_size
    ewma_alpha: float = 0.5            # arrival-rate EWMA smoothing
    pool_cover_s: float = 2.0          # arrivals one warm pool must absorb
                                       # (≈ one cold-boot + refill window)


# ---------------------------------------------------------------------------
@dataclass
class RuntimeInst:
    key: tuple                     # grouping key (fid | tenant, index)
    base_mem: int
    cap: int
    isolate_base: int = MB
    live_mem: int = 0
    live_invocations: int = 0
    last_active: float = 0.0
    ready_at: float = 0.0          # boot completes at this time
    warm_isolates: dict = field(default_factory=dict)  # mem -> (count, t)
    functions_loaded: set = field(default_factory=set)

    def mem(self) -> int:
        # pooled isolates hold only their pre-allocated heap (~1 MB, paper
        # Fig 3); an invocation's working memory is freed at completion
        pool = sum(c for c, _ in self.warm_isolates.values()) \
            * self.isolate_base
        return self.base_mem + self.live_mem + pool


@dataclass
class Node:
    """One machine: its runtime instances, warm pool, snapshot store, and
    (cluster model) EWMA arrival-rate state for adaptive pool sizing."""
    idx: int
    cap: int
    insts: dict = field(default_factory=dict)  # group key -> [RuntimeInst]
    pool_avail: int = 0
    pool_target: int = 0
    pool_pending: int = 0          # refills scheduled but not landed
    rate: float = 0.0              # EWMA arrivals/s
    last_arrival: float = float("-inf")
    snapshots: set = field(default_factory=set)  # fids snapshotted locally


@dataclass
class SimResult:
    model: str
    latencies: list = field(default_factory=list)
    overheads: list = field(default_factory=list)  # latency - pure duration
    mem_samples: list = field(default_factory=list)     # (t, bytes)
    pool_mem_samples: list = field(default_factory=list)  # (t, bytes)
    runtime_count_samples: list = field(default_factory=list)  # (t, n)
    cold_runtime_starts: int = 0
    cold_isolate_starts: int = 0
    warm_isolate_starts: int = 0
    evicted_runtimes: int = 0
    dropped: int = 0
    pool_claims: int = 0           # warm platform-pool instance claims
    transfers: int = 0             # cross-node snapshot transfers
    peak_pool_mem: int = 0         # max bytes held by warm pool slots
    n_nodes: int = 1

    def p(self, q) -> float:
        """Latency percentile; NaN (not a crash) on an empty trace."""
        return float(np.percentile(self.latencies, q)) \
            if self.latencies else float("nan")

    def mean_mem(self) -> float:
        if not self.mem_samples:
            return float("nan")
        return float(np.mean([m for _, m in self.mem_samples]))

    def mean_pool_mem(self) -> float:
        if not self.pool_mem_samples:
            return 0.0
        return float(np.mean([m for _, m in self.pool_mem_samples]))

    def mean_runtimes(self) -> float:
        if not self.runtime_count_samples:
            return float("nan")
        return float(np.mean([n for _, n in self.runtime_count_samples]))

    def ops_per_gb_s(self) -> float:
        """Density: completed invocations per GB-second of fleet footprint
        (the paper's headline 2.41x metric)."""
        if not self.mem_samples or not self.latencies:
            return float("nan")
        duration = self.mem_samples[-1][0]
        gb = self.mean_mem() / GB
        if duration <= 0 or gb <= 0 or not np.isfinite(gb):
            return float("nan")
        return len(self.latencies) / (gb * duration)

    def summary(self) -> dict:
        return {
            "model": self.model,
            "requests": len(self.latencies),
            "p50_s": self.p(50), "p99_s": self.p(99),
            "overhead_p99_ms": 1e3 * float(np.percentile(self.overheads, 99))
            if self.overheads else float("nan"),
            "mean_mem_mb": self.mean_mem() / MB,
            "peak_mem_mb": max(m for _, m in self.mem_samples) / MB
            if self.mem_samples else 0,
            "mean_runtimes": self.mean_runtimes(),
            "cold_runtime": self.cold_runtime_starts,
            "evicted_runtimes": self.evicted_runtimes,
            "cold_isolate": self.cold_isolate_starts,
            "warm_isolate": self.warm_isolate_starts,
            "dropped": self.dropped,
            "pool_claims": self.pool_claims,
            "transfers": self.transfers,
            "peak_pool_mem_mb": self.peak_pool_mem / MB,
            "mean_pool_mem_mb": self.mean_pool_mem() / MB,
            "ops_per_gb_s": self.ops_per_gb_s(),
            "n_nodes": self.n_nodes,
        }


# ---------------------------------------------------------------------------
def _time_sorted(seq) -> bool:
    prev = None
    for inv in seq:
        if prev is not None and inv.t < prev:
            return False
        prev = inv.t
    return True


# ---------------------------------------------------------------------------
class Engine:
    """One simulation run: an event heap plus shared mechanics, with all
    policy delegated to ``self.model`` (a ``PlatformModel``)."""

    def __init__(self, model, params: SimParams, sample_dt: float = 1.0):
        self.model = model
        self.p = params
        self.sample_dt = sample_dt
        self.res = SimResult(model=model.name, n_nodes=model.n_nodes)
        self.nodes = [Node(idx=i, cap=model.node_cap)
                      for i in range(model.n_nodes)]
        for nd in self.nodes:
            model.init_node(nd)
        # heap entries are (t, tier, seq, kind, payload). Tier 0 is trace
        # arrivals, tier 1 everything the engine pushes dynamically: in
        # the eager days every arrival was pushed before any dynamic
        # event, so at equal t the arrival's smaller seq won — the tier
        # keeps that ordering bit-exact now that arrivals stream in
        # lazily with *later* seqs.
        self.events: list = []
        self.seq = 0

    # -- event heap --------------------------------------------------------
    def push(self, t: float, kind: str, payload) -> None:
        self.seq += 1
        heapq.heappush(self.events, (t, 1, self.seq, kind, payload))

    def _push_arrival(self, inv) -> None:
        self.seq += 1
        heapq.heappush(self.events, (inv.t, 0, self.seq, "arrive",
                                     (inv, inv.t)))

    # -- accounting --------------------------------------------------------
    def node_mem(self, nd: Node) -> int:
        return sum(r.mem() for g in nd.insts.values() for r in g) \
            + nd.pool_avail * self.model.base_mem

    def fleet_mem(self) -> int:
        return sum(self.node_mem(nd) for nd in self.nodes)

    def fleet_pool_mem(self) -> int:
        return sum(nd.pool_avail for nd in self.nodes) * self.model.base_mem

    def n_runtimes(self) -> int:
        return sum(len(g) for nd in self.nodes for g in nd.insts.values()) \
            + sum(nd.pool_avail for nd in self.nodes)

    def note_pool_peak(self) -> None:
        self.res.peak_pool_mem = max(self.res.peak_pool_mem,
                                     self.fleet_pool_mem())

    # -- run ---------------------------------------------------------------
    def run(self, trace) -> SimResult:
        """``trace`` may be any iterable of :class:`Invocation`. A
        time-sorted input (every ``Trace``, every ``StreamingTrace``) is
        fed into the heap lazily — one pending arrival at a time — so a
        streamed trace never materializes; the heap holds only in-flight
        events. An unsorted ``Sequence`` falls back to the old eager
        push-everything path (identical results); an unsorted plain
        iterator cannot be simulated single-pass and raises."""
        p, res, model = self.p, self.res, self.model
        arrivals = iter(trace)
        nxt = next(arrivals, None)
        if isinstance(trace, Sequence) and not _time_sorted(trace):
            while nxt is not None:
                self._push_arrival(nxt)
                nxt = next(arrivals, None)

        res.peak_pool_mem = self.fleet_pool_mem()
        next_sample = 0.0
        while self.events or nxt is not None:
            while nxt is not None and (
                    not self.events
                    or (nxt.t, 0) <= (self.events[0][0], self.events[0][1])):
                self._push_arrival(nxt)
                prev_t = nxt.t
                nxt = next(arrivals, None)
                if nxt is not None and nxt.t < prev_t:
                    raise ValueError(
                        f"trace iterator is not time-sorted: arrival at "
                        f"t={nxt.t} after t={prev_t}; sort the trace or "
                        f"pass a Sequence")
            t, _, _, kind, payload = heapq.heappop(self.events)
            while next_sample <= t:
                res.mem_samples.append((next_sample, self.fleet_mem()))
                res.pool_mem_samples.append(
                    (next_sample, self.fleet_pool_mem()))
                res.runtime_count_samples.append(
                    (next_sample, self.n_runtimes()))
                self.note_pool_peak()
                next_sample += self.sample_dt

            if kind == "done":
                nd, inst, inv = payload
                inst.live_invocations -= 1
                inst.last_active = t
                model.on_idle(self, nd, inst, inv, t)
                continue

            if kind == "drain":
                # HydraPlatform._return_runtime: an emptied runtime that
                # stays idle past the TTL becomes a generic warm-pool slot
                # again (or shuts down when the pool is already at target)
                # — its loaded functions survive only as node-local
                # snapshots
                nd, inst = payload
                group = nd.insts.get(inst.key[:-1], [])
                if (inst in group and inst.live_invocations == 0
                        and t - inst.last_active
                        >= p.pool_drain_ttl_s - 1e-9):
                    group.remove(inst)
                    if nd.pool_avail < nd.pool_target:
                        nd.pool_avail += 1
                        self.note_pool_peak()
                continue

            if kind == "evict":
                inst, mem = payload
                cnt, last = inst.warm_isolates.get(mem, (0, t))
                if cnt > 0 and t - last >= p.isolate_ttl_s - 1e-9:
                    inst.warm_isolates[mem] = (0, last)
                continue

            if kind == "refill":
                # background re-warm of a claimed pool slot (off the
                # request path). No node headroom right now -> retry later
                # rather than dropping the slot, like a real re-warmer
                # would. An adaptively-shrunk target just drops the
                # now-surplus slot.
                nd = payload
                nd.pool_pending = max(0, nd.pool_pending - 1)
                if nd.pool_avail < nd.pool_target:
                    if self.node_mem(nd) + model.base_mem <= nd.cap:
                        nd.pool_avail += 1
                        self.note_pool_peak()
                    else:
                        nd.pool_pending += 1
                        self.push(t + p.pool_refill_s, "refill", nd)
                continue

            if kind == "expire":
                nd, key = payload
                group = nd.insts.get(key, [])
                keep = [r for r in group
                        if r.live_invocations > 0
                        or t - r.last_active < p.keepalive_s - 1e-9]
                nd.insts[key] = keep
                continue

            # ---- arrival (possibly a queued retry) ----
            inv, orig_t = payload
            startup = 0.0
            need = inv.mem_bytes + p.isolate_base
            key = model.group_key(inv)

            nd, inst, warm_worker = model.on_arrival(self, inv, need, key)

            if inst is None:
                # new runtime instance: the model picks the node and
                # whether to claim a pre-warmed pool slot; the engine then
                # applies shared admission mechanics — if the node has no
                # room, LRU-evict idle runtimes first (platforms reclaim
                # keep-alive workers); else queue with backoff / give up.
                # A pool claim adds no net base memory: the slot's RSS is
                # already counted in node_mem().
                nd, claim_pool = model.pick_node(self, inv, need)
                extra = need if claim_pool else model.base_mem + need
                if self.node_mem(nd) + extra > nd.cap:
                    idle = sorted((r for g in nd.insts.values() for r in g
                                   if r.live_invocations == 0),
                                  key=lambda r: r.last_active)
                    while idle and self.node_mem(nd) + extra > nd.cap:
                        victim = idle.pop(0)
                        nd.insts[victim.key[:-1]].remove(victim)
                        self.res.evicted_runtimes += 1
                if self.node_mem(nd) + extra > nd.cap:
                    if t - orig_t >= p.max_wait_s:
                        res.dropped += 1
                    else:
                        self.push(t + p.retry_backoff_s, "arrive",
                                  (inv, orig_t))
                    continue
                group = nd.insts.setdefault(key, [])
                inst = RuntimeInst(key=key + (len(group),),
                                   base_mem=model.base_mem,
                                   cap=model.runtime_cap(need),
                                   isolate_base=p.isolate_base)
                group.append(inst)
                model.on_boot(inst, inv)
                if claim_pool:
                    nd.pool_avail -= 1
                    startup += p.pool_claim_s
                    res.pool_claims += 1
                    nd.pool_pending += 1
                    self.push(t + p.pool_refill_s, "refill", nd)
                else:
                    startup += p.vm_boot_s + model.runtime_cold_s
                    res.cold_runtime_starts += 1
                inst.ready_at = t + startup
            else:
                # joining an instance that may still be booting: the
                # invocation waits for the remaining boot time (cold-start
                # amplification under bursts — a warm pool instance is
                # ready ~immediately)
                startup += max(0.0, inst.ready_at - t)

            # the serving node observed an arrival: the model may retarget
            # its warm pool (EWMA-adaptive sizing, cluster model)
            model.adapt_pool(self, nd, t)

            # per-runtime code install (policy: first install vs snapshot
            # restore vs cross-node snapshot transfer)
            startup += model.startup_cost(self, nd, inst, inv)

            # isolate acquire (policy: worker-resident vs pooled isolates)
            startup += model.acquire_isolate(self, inst, inv, warm_worker, t)

            inst.live_invocations += 1
            inst.last_active = t
            latency = (t - orig_t) + startup + inv.duration_s
            res.latencies.append(latency)
            res.overheads.append(latency - inv.duration_s)
            self.push(t + startup + inv.duration_s, "done", (nd, inst, inv))
            self.push(t + startup + inv.duration_s + p.keepalive_s,
                      "expire", (nd, key))

        return res
