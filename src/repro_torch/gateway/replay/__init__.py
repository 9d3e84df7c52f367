"""One-call orchestration: trace + live stack -> SimResult.

``replay_trace`` wires the pieces — target adapter, trace workload,
recorder (sampler thread + calibration probe), gateway workers,
optional platform autoscaler or cluster balancer, open-loop load
generator — runs the replay, drains, and returns ``(SimResult,
extras)``. ``extras["probe"]`` carries the ``CalibrationProbe`` payload
that ``core.calibrate.calibration_from_replay`` turns into a
``SimParams`` overlay (the gateway -> calibration -> sim round trip);
cluster replays additionally report mid-burst migration accounting
(``migrations``/``transfer_s``/``transfer_bytes``) for the live-vs-sim
diff.

The caller owns the target's lifecycle: build the
runtime/platform/cluster, replay, then ``target.shutdown()``. That
keeps replays composable (e.g. two traces back-to-back against one
warm platform to measure the warm-path delta).

This module is a package (``replay/__init__.py``) rather than
``replay.py`` so that the documentation's ``gateway/replay.py``
references keep resolving to one file (hydralint HL006).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.tracing import FlightRecorder, Tracer
from repro_torch.gateway.gateway import (Autoscaler, ClusterBalancer, Gateway,
                                   GatewayParams)
from repro_torch.gateway.loadgen import LoadGenerator, ShardedLoadGenerator
from repro_torch.gateway.recorder import CalibrationProbe, Recorder
from repro_torch.gateway.targets import DEFAULT_RUNTIME_BASE, wrap_target
from repro_torch.gateway.workload import TraceWorkload


@dataclass
class ReplayConfig:
    compress: float = 60.0             # trace seconds per wall second
    mem_scale: float = 1.0 / 64        # trace bytes -> live arena bytes
    n_workers: int = 16
    queue_depth: int = 256
    slo_timeout_s: Optional[float] = None   # trace seconds; None disables
    tenant_rate: Optional[float] = None     # trace req/s; None disables
    tenant_burst: float = 16.0
    sample_dt_s: float = 0.25          # wall seconds between fleet samples
    shards: int = 1                    # tenant-sharded load-gen threads
                                       # (high --compress; 1 = single loop)
    autoscale: bool = True             # platform targets only
    pool_min: int = 1
    pool_max: int = 8
    cover_s: float = 1.0               # wall seconds one warm pool absorbs
    runtime_base_bytes: int = DEFAULT_RUNTIME_BASE
    drain_timeout_s: float = 120.0     # wall seconds
    probe: bool = True                 # record the calibration payload
    warm_executables: bool = True      # build programs before the clock starts
    # cluster targets only: burst-time migration/rebalance in the loop
    balance: bool = True
    balance_interval_s: float = 0.25   # wall seconds between balance ticks
    balance_imbalance: float = 0.25    # commit spread / node budget trigger
    balance_min_queue: int = 1         # queued requests = live-burst signal
    balance_max_moves: int = 4         # migrations per rebalance() call
    # request tracing (core/tracing): 0.0 = off (the gateway carries the
    # zero-cost NULL_TRACE); >0 head-samples that fraction of admitted
    # requests deterministically under trace_seed
    trace_sample: float = 0.0
    trace_seed: int = 0
    trace_max: int = 4096              # bounded export window (traces kept)
    flight_dir: Optional[str] = None   # anomaly flight-recorder output dir
    flight_ring: int = 256             # last-N traces dumped per anomaly


def _budget_of(adapter) -> Optional[int]:
    """The per-runtime byte budget of the adapted stack, used to cap the
    emulated workload's arenas so registration always admits."""
    t = adapter.target
    if adapter.kind == "platform":
        return t.params.runtime_budget_bytes
    if adapter.kind == "cluster":
        return t.params.platform.runtime_budget_bytes
    if adapter.kind == "runtime":
        return t.budget.capacity
    return None


def build_workload(adapter, cfg: ReplayConfig) -> TraceWorkload:
    wl = TraceWorkload(mem_scale=cfg.mem_scale,
                       device=adapter.target.device)
    budget = _budget_of(adapter)
    if budget is not None:
        # a function's placement estimate is ~2 arenas + O(1 KB); keep
        # even the biggest trace function admissible on one runtime
        cap = max(64 * 1024, (budget - 8 * 1024) // 2)
        wl.max_arena_bytes = cap
        wl.min_arena_bytes = min(wl.min_arena_bytes, cap)
    return wl


def warm_executables(adapter, workload, trace,
                     errors: Optional[list] = None) -> int:
    """Build the workload's shared program into the target's executable
    cache(s) before the replay clock starts.

    The paper's platform compiles at deploy time (Native Image analog),
    and the sim's ``fn_register_s`` models a code *install* from the
    shared cache — so the one-time build of the emulated program
    must not land on the first request of the measured window, where it
    would masquerade as seconds of trace-time cold start and poison both
    the latency gates and the derived calibration. A scratch runtime
    sharing each cache registers one representative spec through the
    real path (same cache key) on the adapter's device, so the program
    records that device and the device's lazy first launch happens here
    too, then shuts down; its budget is sized
    from the spec's own registration reserve so a big-arena workload
    cannot OOM the warm-up. Warming is best-effort — a failure means
    the first request pays the compile (pre-warm behaviour), never an
    aborted replay. Returns the number of caches warmed; a cache that
    failed to warm appends its exception's repr to ``errors``, if given."""
    from repro_torch.core.runtime import HydraRuntime, registration_budget

    inv = next(iter(trace), None)
    if inv is None:
        return 0
    spec = workload.spec_for(inv.fid, inv.mem_bytes)
    budget = max(64 * (1 << 20), 2 * registration_budget(spec)[0])
    warmed = 0
    for cache in adapter.exe_caches():
        if cache is None:
            continue
        try:
            rt = HydraRuntime(device=adapter.target.device,
                              memory_budget_bytes=budget,
                              executable_cache=cache, n_workers=1,
                              janitor=False)
            try:
                rt.register_function("__warm__", spec, tenant="__warm__")
                # a torch program has no compile step: one call is what
                # loads its device code (CUDA loads modules lazily)
                rt.invoke("__warm__", workload.args_for(inv))
            finally:
                rt.shutdown()
            warmed += 1
        except Exception as e:
            if errors is not None:
                errors.append(repr(e))
    return warmed


def replay_trace(trace, target, cfg: Optional[ReplayConfig] = None,
                 tracer: Optional[Tracer] = None):
    """Replay ``trace`` open-loop against ``target`` (a ``HydraRuntime``,
    ``HydraPlatform``, or ``HydraCluster``). Returns ``(SimResult,
    extras)`` — the result in the simulator's schema, plus live-only
    detail (drop reasons, invoke errors, load-generator lag, wall
    time, and under ``warm`` the caches warmed and their compile counts
    when the clock started). Pass ``tracer`` (or set ``cfg.trace_sample``/``flight_dir``)
    to span-trace sampled requests; the caller keeps the tracer for
    Chrome export, and ``extras["tracing"]`` carries the per-phase
    aggregate either way."""
    cfg = cfg or ReplayConfig()
    adapter = wrap_target(target, cfg.runtime_base_bytes)
    workload = build_workload(adapter, cfg)
    n_registered = workload.register_all(trace, adapter)
    caches = [c for c in adapter.exe_caches() if c is not None]
    warm_errors: list = []
    warmed = warm_executables(adapter, workload, trace, warm_errors) \
        if cfg.warm_executables else 0

    if tracer is None and (cfg.trace_sample > 0 or cfg.flight_dir):
        flight = FlightRecorder(cfg.flight_dir, ring=cfg.flight_ring) \
            if cfg.flight_dir else None
        tracer = Tracer(cfg.trace_sample if cfg.trace_sample > 0 else 1.0,
                        seed=cfg.trace_seed, max_traces=cfg.trace_max,
                        flight=flight)
    if tracer is not None:
        # flight dumps embed a fleet snapshot taken at anomaly time
        tracer.set_metrics_provider(
            lambda: {"fleet": adapter.sample(),
                     "counters": adapter.counters()})

    probe = CalibrationProbe(adapter, compress=cfg.compress,
                             tracer=tracer) \
        if cfg.probe else None
    recorder = Recorder(adapter, compress=cfg.compress,
                        sample_dt_s=cfg.sample_dt_s, probe=probe,
                        tracer=tracer)
    autoscaler = balancer = None
    if cfg.autoscale and adapter.kind == "platform":
        autoscaler = Autoscaler(target, pool_min=cfg.pool_min,
                                pool_max=cfg.pool_max, cover_s=cfg.cover_s)
    gw = Gateway(adapter, workload,
                 GatewayParams(n_workers=cfg.n_workers,
                               queue_depth=cfg.queue_depth,
                               slo_timeout_s=cfg.slo_timeout_s,
                               tenant_rate=cfg.tenant_rate,
                               tenant_burst=cfg.tenant_burst,
                               compress=cfg.compress),
                 recorder, autoscaler=autoscaler, tracer=tracer)
    if cfg.balance and adapter.kind == "cluster":
        balancer = ClusterBalancer(target, gw,
                                   interval_s=cfg.balance_interval_s,
                                   imbalance=cfg.balance_imbalance,
                                   min_queue=cfg.balance_min_queue,
                                   max_moves=cfg.balance_max_moves)

    # what the warm-up did, read back: a cache it missed shows here, and
    # the compiles on the clock are the caches' counts less these
    warm = {"caches": len(caches), "warmed": warmed,
            "compiles_before_clock": [c.stats()["compiles"] for c in caches],
            "errors": warm_errors}
    t0 = time.monotonic()
    recorder.start(t0)
    gw.start()
    if autoscaler is not None:
        autoscaler.start()
    if balancer is not None:
        balancer.start()
    try:
        gen = ShardedLoadGenerator(trace, gw, cfg.compress,
                                   n_shards=cfg.shards) \
            if cfg.shards > 1 else LoadGenerator(trace, gw, cfg.compress)
        load = gen.run(t0)
        drained = gw.drain(timeout_s=cfg.drain_timeout_s)
    finally:
        gw.stop()
        if autoscaler is not None:
            autoscaler.stop()
        if balancer is not None:
            balancer.stop()
        recorder.stop()

    res = recorder.finish()        # n_nodes from the adapter's real count
    extras = {
        **recorder.extras(),
        "registered": n_registered,
        "submitted": load.submitted,
        "accepted": load.accepted,
        "late_arrivals": load.late,
        "max_lag_s": load.max_lag_s,
        "wall_s": time.monotonic() - t0,
        "drained": drained,
        "autoscaler_resizes": autoscaler.resizes if autoscaler else 0,
        "warm": warm,
    }
    if probe is not None:
        extras["probe"] = probe.finish()
    if adapter.kind == "cluster":
        # mid-burst migration accounting, diffable against the sim's
        # hydra-cluster transfer modelling (SimResult.transfers)
        cm = target.metrics
        extras["balancer"] = {
            "armed": balancer.armed if balancer else False,
            "ticks": balancer.ticks if balancer else 0,
            "rebalances": balancer.rebalances if balancer else 0,
            "moves": balancer.moves if balancer else 0,
            "errors": balancer.errors if balancer else 0,
            "migrations": cm.counters.get("migrations", 0),
            "transfer_s": cm.hist("transfer_s").sum,
            "transfer_bytes": cm.counters.get("transfer_bytes", 0),
            # HL004: the cluster's own accounting of the same activity the
            # balancer counts above — drift between the two pairs is a
            # replay diagnostic, and the adaptive-pool resizes are the
            # cluster analog of autoscaler_resizes
            "rebalance_calls": cm.counters.get("rebalance.calls", 0),
            "rebalance_moves": cm.counters.get("rebalance.moves", 0),
            "pool_resizes": cm.counters.get("pool.resize", 0),
        }
    return res, extras
