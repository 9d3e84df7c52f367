"""Multi-tenant serving driver: HydraCluster/HydraPlatform/HydraRuntime +
continuous batching, plus the live trace-replay gateway.

Two modes, as in ``repro.launch.serve``:

**Closed-loop LM serving** (default): registers N tenant functions
(optionally different architectures, each at its ``reduced()`` size) and
replays a synthetic request stream through continuous batchers, reporting
density metrics: placement, pool behaviour, program-cache sharing, tokens
per second. ``--trace-out PATH`` traces every request and step of the
batchers (``core/tracing``) and writes their request tracks and step
track as Chrome trace-event JSON, which ``python -m
repro_torch.core.tracing --check PATH`` validates.

**Open-loop gateway replay** (``--gateway``): replays a trace — an Azure
Functions 2019 CSV via ``--trace-file``, or the synthetic generator — in
wall-clock time against the selected live stack through
``repro_torch.gateway``: per-tenant bounded queues, admission control,
SLO timeouts, background pool autoscaling, and a ``SimResult``-schema
summary directly comparable with ``repro_torch.core.sim`` output.
``--compress`` sets how many trace seconds replay per wall second;
``--round-trip`` runs the gateway -> calibration -> sim validation loop
instead. Gateway-only flags without ``--gateway`` are rejected (exit 2).

``--calibration PATH`` writes the run's measured costs (runtime boot,
register, restore; in gateway mode the replay's ``CalibrationProbe``) as
a hydra-calibration/v1 JSON for the simulator, in either mode.

The serving stack is selected by flags (both modes):

  * ``--nodes K`` (K >= 2) — a ``HydraCluster`` of K logical nodes:
    colocation-aware cross-node placement, snapshot migration, and
    EWMA-adaptive per-node pre-warmed pools.
  * ``--pool N`` (default 2, with ``--nodes`` < 2) — one ``HydraPlatform``:
    a pre-warmed pool of N generic runtimes with colocation-aware
    placement and snapshot/restore.
  * ``--pool 0`` — a single raw ``HydraRuntime``.

``--runtime-budget-gb`` caps each runtime's memory budget,
``--node-memory-gb`` each cluster node's placement budget, and
``--snapshot-dir`` enables sandbox snapshot/evict/restore (and is required
for cluster migration). It runs on CUDA unless ``--device cpu`` is given;
every runtime of the stack runs on that one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --tenants 2 --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --nodes 2 --pool 1
  PYTHONPATH=src python -m repro_torch.launch.serve --gateway \\
      --trace-file benchmarks/data/azure_sample.csv --compress 60

This module is a package (``serve/__init__.py``) rather than
``serve.py`` so that the documentation's bare ``launch/serve.py``
references keep resolving to one file; the module path
``repro_torch.launch.serve`` mirrors ``repro.launch.serve``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (ClusterParams, ContinuousBatcher, HydraCluster,
                              HydraPlatform, HydraRuntime, LMSpec,
                              PlatformParams)
from repro_torch.core.tracing import NULL_TRACE, Tracer, export_chrome
from repro_torch.device import resolve_device
from repro_torch.models.programs import ModelProgram


def find_tcmalloc() -> str:
    """Locate a tcmalloc shared library, or ''. Checked glob-first (the
    common Debian/Ubuntu multiarch paths), then the linker cache."""
    for pat in ("/usr/lib/*/libtcmalloc.so*",
                "/usr/lib/*/libtcmalloc_minimal.so*",
                "/usr/lib64/libtcmalloc*.so*",
                "/usr/lib/libtcmalloc*.so*"):
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    try:
        import ctypes.util
        return (ctypes.util.find_library("tcmalloc")
                or ctypes.util.find_library("tcmalloc_minimal") or "")
    except Exception:
        return ""


def maybe_reexec_tcmalloc(argv) -> None:
    """Re-exec this process with tcmalloc LD_PRELOADed (many same-sized
    slab mints and frees across threads are tcmalloc's thread-cache sweet
    spot; glibc malloc serializes them on arena locks). A no-op when
    tcmalloc is already preloaded (the guard that ends the exec loop) or
    when no library is installed. The large-alloc report threshold is
    raised so multi-GB host allocations don't spam stderr."""
    if "tcmalloc" in os.environ.get("LD_PRELOAD", ""):
        return
    lib = find_tcmalloc()
    if not lib:
        print("[serve] --tcmalloc: no libtcmalloc found; continuing "
              "with the default allocator", file=sys.stderr)
        return
    env = dict(os.environ)
    env["LD_PRELOAD"] = f"{lib} {env.get('LD_PRELOAD', '')}".strip()
    env.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "60000000000")
    os.execve(sys.executable,
              [sys.executable, "-m", "repro_torch.launch.serve", *argv], env)


def make_params(cfg, seed: int = 0, device=None):
    """The port's own seeded init, cast to bf16 for serving."""
    return ModelProgram(cfg).init(seed, device=device, dtype=torch.bfloat16)


def build_target(args, device, arena_ttl_s=None):
    """The serving stack selected by --nodes/--pool, every runtime of it
    on ``device`` — one construction path shared by the closed-loop
    driver and gateway mode, so the same flags always mean the same
    deployment. ``arena_ttl_s`` overrides the isolate keep-alive (gateway
    mode compresses it); None keeps the stack defaults."""
    budget = int(args.runtime_budget_gb * (1 << 30))
    ttl = {} if arena_ttl_s is None else {"arena_ttl_s": arena_ttl_s}
    if args.nodes >= 2:
        return HydraCluster(ClusterParams(
            n_nodes=args.nodes,
            node_memory_bytes=int(args.node_memory_gb * (1 << 30)),
            snapshot_dir=args.snapshot_dir,
            platform=PlatformParams(pool_size=max(args.pool, 1),
                                    runtime_budget_bytes=budget,
                                    device=device, **ttl)))
    if args.pool > 0:
        return HydraPlatform(PlatformParams(
            pool_size=args.pool, runtime_budget_bytes=budget,
            snapshot_dir=args.snapshot_dir, device=device, **ttl))
    return HydraRuntime(device=device, memory_budget_bytes=budget, **ttl)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="qwen2.5-3b",
                    help="comma-separated model architectures to serve "
                         "(the dense, ssm and hybrid families are ported, "
                         "e.g. qwen2.5-3b,mamba2-780m,zamba2-2.7b)")
    ap.add_argument("--tenants", type=int, default=2,
                    help="tenants per architecture (each gets its own "
                         "registered function)")
    ap.add_argument("--requests", type=int, default=16,
                    help="closed-loop requests to issue in total")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous-batching slots per LM function")
    ap.add_argument("--max-seq", type=int, default=128,
                    help="KV-cache sequence capacity per slot")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="synthetic prompt length in tokens")
    ap.add_argument("--max-new", type=int, default=16,
                    help="tokens to generate per request")
    ap.add_argument("--pool", type=int, default=2,
                    help="pre-warmed platform pool size (0 = raw runtime)")
    ap.add_argument("--nodes", type=int, default=0,
                    help="serve through a HydraCluster of this many "
                         "logical nodes (< 2 = single-node "
                         "platform/runtime)")
    ap.add_argument("--runtime-budget-gb", type=float, default=8.0,
                    help="per-runtime memory budget in GiB (registration "
                         "admission + arena capacity)")
    ap.add_argument("--node-memory-gb", type=float, default=16.0,
                    help="per-node placement budget (cluster mode)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="enable sandbox snapshot/restore under this dir")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the request stream and "
                         "synthetic traces")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to serve on")
    ap.add_argument("--calibration", default=None,
                    help="after serving, write measured costs (runtime "
                         "boot, register, restore) as a "
                         "hydra-calibration/v1 JSON for the trace "
                         "simulator; in gateway mode the costs come from "
                         "the replay's CalibrationProbe")
    # ---- gateway mode: open-loop wall-clock trace replay ----
    ap.add_argument("--gateway", action="store_true",
                    help="replay a trace open-loop in wall-clock time "
                         "through the serving gateway (repro_torch.gateway) "
                         "instead of the closed-loop LM driver")
    ap.add_argument("--trace-file", default=None,
                    help="Azure Functions 2019-format invocations CSV "
                         "(gateway mode; default: a synthetic trace)")
    ap.add_argument("--compress", type=float, default=60.0,
                    help="trace seconds replayed per wall second "
                         "(gateway mode)")
    ap.add_argument("--target-rps", type=float, default=None,
                    help="deterministically thin the trace to this mean "
                         "rps (gateway mode)")
    ap.add_argument("--max-minutes", type=int, default=None,
                    help="replay only the first N trace minutes "
                         "(gateway mode)")
    ap.add_argument("--mem-scale", type=float, default=1.0 / 64,
                    help="trace function memory -> live arena scale "
                         "(gateway mode)")
    ap.add_argument("--gw-workers", type=int, default=16,
                    help="gateway worker threads (gateway mode)")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="per-tenant gateway queue bound (gateway mode)")
    ap.add_argument("--slo-timeout", type=float, default=None,
                    help="drop requests older than this many TRACE "
                         "seconds instead of serving them late "
                         "(gateway mode)")
    ap.add_argument("--tenant-rate", type=float, default=None,
                    help="per-tenant token-bucket rate in trace req/s "
                         "(gateway mode)")
    ap.add_argument("--tcmalloc", action="store_true",
                    help="re-exec with tcmalloc LD_PRELOADed when the "
                         "library is installed; silently keeps the "
                         "default allocator when libtcmalloc is absent")
    ap.add_argument("--round-trip", action="store_true",
                    help="gateway mode: close the gateway -> calibration "
                         "-> sim loop — replay live, derive a calibration "
                         "from that run, re-simulate with it, and report "
                         "whether the calibrated sim tracks live at least "
                         "as tightly as the uncalibrated sim "
                         "(repro_torch.gateway.validate; always validates "
                         "the single-node platform stack, so --nodes is "
                         "ignored)")
    ap.add_argument("--attribute", action="store_true",
                    help="with --round-trip: trace the live leg and "
                         "report which request phase dominates the "
                         "live-vs-sim cold and p99 deltas")
    # ---- request tracing (gateway mode; repro_torch.core.tracing) ----
    ap.add_argument("--trace-out", default=None,
                    help="write sampled request spans as Chrome "
                         "trace-event JSON to this path after the replay "
                         "(gateway mode), or every LM request's track and "
                         "the batchers' step track after the run")
    ap.add_argument("--trace-sample", type=float, default=None,
                    help="head-sampling rate for request tracing in "
                         "[0,1] (gateway mode; default 1.0 when "
                         "--trace-out/--flight-recorder is given, else "
                         "tracing stays off)")
    ap.add_argument("--flight-recorder", default=None, dest="flight_dir",
                    metavar="DIR",
                    help="keep a ring of recent request traces and dump "
                         "them with a fleet snapshot as JSONL under DIR "
                         "on each anomaly (gateway mode)")
    args = ap.parse_args(argv)

    if args.tcmalloc:
        # returns only when tcmalloc is already active or unavailable
        maybe_reexec_tcmalloc(sys.argv[1:] if argv is None else argv)

    if not args.gateway:
        # gateway-only flags would silently do nothing without --gateway;
        # reject the combos instead (parser.error exits 2)
        gateway_only = [("--trace-file", args.trace_file is not None),
                        ("--round-trip", args.round_trip),
                        ("--target-rps", args.target_rps is not None),
                        ("--max-minutes", args.max_minutes is not None),
                        ("--slo-timeout", args.slo_timeout is not None),
                        ("--tenant-rate", args.tenant_rate is not None),
                        ("--attribute", args.attribute),
                        ("--trace-sample", args.trace_sample is not None),
                        ("--flight-recorder", args.flight_dir is not None)]
        used = [flag for flag, on in gateway_only if on]
        if used:
            ap.error(f"{', '.join(used)} require(s) --gateway "
                     f"(open-loop trace replay mode)")

    if args.round_trip:
        # the validation loop owns its own tracer (--attribute); the raw
        # span-export flags only make sense on a plain gateway replay
        trace_flags = [("--trace-out", args.trace_out is not None),
                       ("--trace-sample", args.trace_sample is not None),
                       ("--flight-recorder", args.flight_dir is not None)]
        used = [flag for flag, on in trace_flags if on]
        if used:
            ap.error(f"{', '.join(used)} cannot be combined with "
                     f"--round-trip (use --attribute for phase "
                     f"attribution of the validation deltas)")
    elif args.attribute:
        ap.error("--attribute requires --round-trip (it attributes the "
                 "live-vs-sim validation deltas)")

    device = resolve_device(args.device)
    if args.gateway:
        return run_gateway(args, device)
    target = build_target(args, device)
    try:
        return _serve(args, target, device)
    finally:
        target.shutdown()


def _serve(args, target, device) -> dict:
    if isinstance(target, (HydraCluster, HydraPlatform)):
        platform = target
        # eager: place at registration so t_reg measures the real
        # install cost and no request pays a cold start
        register = lambda fid, spec, tenant: platform.register_function(
            fid, spec, tenant=tenant, eager=True)
        runtime_for = platform.runtime_for
        exe_cache = platform.exe_cache
    else:
        platform, rt = None, target
        register = rt.register_function
        runtime_for = lambda fid: rt
        exe_cache = rt.exe_cache
    archs = args.archs.split(",")
    rng = np.random.default_rng(args.seed)

    # one set of weights per tenant; every tenant of an arch shares the
    # same programs (code-cache sharing) but registers its own function
    t0 = time.perf_counter()
    fids = []
    for t in range(args.tenants):
        arch = archs[t % len(archs)]
        cfg = get_config(arch).reduced()
        spec = LMSpec(cfg=cfg, params=make_params(cfg, seed=args.seed + t,
                                                  device=device),
                      max_seq=args.max_seq, slots=args.slots)
        fid = f"tenant{t}/{arch}"
        register(fid, spec, tenant=f"tenant{t}")
        fids.append(fid)
    t_reg = time.perf_counter() - t0

    tracer = Tracer(seed=args.seed) if args.trace_out is not None else None
    batchers = {fid: ContinuousBatcher(runtime_for(fid), fid, tracer=tracer)
                for fid in fids}
    print(f"[serve] registered {len(fids)} functions in {t_reg:.1f}s on "
          f"{device} (exe cache: {exe_cache.stats()})")

    futs = []
    t0 = time.perf_counter()
    try:
        for _ in range(args.requests):
            fid = fids[int(rng.integers(len(fids)))]
            prompt = rng.integers(2, 100, args.prompt_len).tolist()
            if isinstance(platform, HydraCluster):
                # batchers talk to runtimes directly; tell the cluster
                # about the arrival so adaptive pool sizing sees the load
                platform.observe_arrival(fid)
            ctx = tracer.start_request(fid) if tracer else NULL_TRACE
            futs.append(batchers[fid].submit(prompt, args.max_new, ctx))
            # interleave stepping: every submit, run one tick on all
            for b in batchers.values():
                if b.active or b.pending:
                    b.step()
        for b in batchers.values():
            b.run_until_done()
        toks = sum(len(f.result()) for f in futs)
        dt = time.perf_counter() - t0
    finally:
        for b in batchers.values():
            b.close()

    print(f"[serve] {args.requests} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s)")
    s = target.stats()
    if isinstance(platform, HydraCluster):
        for i, ns in enumerate(s["nodes"]):
            print(f"[serve] node{i}: {ns['runtimes_active']} active, "
                  f"{ns['runtimes_pooled']} pooled (target "
                  f"{ns['pool_target']}), committed "
                  f"{ns['committed_bytes'] / 2**20:.1f} MB")
        print(f"[serve] cluster placement: {platform.placement()}")
        print(f"[serve] cluster metrics: {s['metrics']['counters']}")
    elif platform is not None:
        print(f"[serve] platform: {s['runtimes_active']} active runtimes, "
              f"{s['runtimes_pooled']} pooled, placement "
              f"{platform.placement()}")
        print(f"[serve] platform metrics: {s['metrics']['counters']}")
        print(f"[serve] budget used {s['budget_used'] / 2**20:.0f} MB")
    else:
        print(f"[serve] arena stats: {rt.arena_pool.stats()}")
        print(f"[serve] budget used {s['budget_used'] / 2**20:.0f} MB "
              f"(peak {s['budget_peak'] / 2**20:.0f} MB)")
    print(f"[serve] exe cache: {exe_cache.stats()}")
    if tracer is not None:
        doc = export_chrome(tracer, args.trace_out,
                            meta={"archs": args.archs,
                                  "tenants": args.tenants})
        print(f"[serve] wrote {len(doc['traceEvents'])} trace events "
              f"({len(tracer.traces())} requests, {len(tracer.steps())} "
              f"steps) to {args.trace_out}")
    if args.calibration:
        # dedupe by identity: colocated fids share a runtime, and a
        # duplicated runtime would bias the averaged costs toward it
        rts = list({id(b.rt): b.rt for b in batchers.values()}.values())
        emit_calibration(args.calibration, platform, rts)
    return {**s, "requests": args.requests, "tokens": toks, "wall_s": dt}


def run_gateway(args, device) -> dict:
    """Open-loop wall-clock trace replay through ``repro_torch.gateway``
    against the stack selected by --nodes/--pool on ``device``. Prints
    the live result in the simulator's SimResult summary schema and
    returns it with the replay's ``extras``. ``--round-trip`` instead
    runs the full gateway -> calibration -> sim validation loop and
    prints its delta report."""
    from repro_torch.core.calibrate import (calibration_from_replay,
                                            write_calibration_doc)
    from repro_torch.core.sim import SimParams
    from repro_torch.core.tracing import FlightRecorder
    from repro_torch.gateway import (ReplayConfig, format_report, load_trace,
                                     replay_trace, run_validation)

    trace = load_trace(args.trace_file, target_rps=args.target_rps,
                       max_minutes=args.max_minutes, seed=args.seed)
    d = trace.describe()
    print(f"[gateway] trace: {d['invocations']} invocations, "
          f"{d['functions']} fns, {d['tenants']} tenants over "
          f"{d['duration_s']:.0f}s trace time "
          f"(~{d['duration_s'] / args.compress:.1f}s wall at "
          f"{args.compress:g}x) on {device}")

    if args.round_trip:
        report = run_validation(trace, device=device,
                                compress=args.compress,
                                pool_size=max(args.pool, 1),
                                mem_scale=args.mem_scale,
                                n_workers=args.gw_workers,
                                round_trip=True,
                                attribute=args.attribute)
        print(format_report(report))
        if args.calibration and "calibration" in report:
            write_calibration_doc(args.calibration, report["calibration"])
            print(f"[gateway] wrote calibration {args.calibration}")
        if not report["ok"]:
            # same contract as repro_torch.gateway.validate: a failed gate
            # is a non-zero exit, not a printed FAIL line with exit 0
            raise SystemExit(1)
        return report

    # trace-time TTL semantics must follow the replay clock: the sim's
    # isolate keep-alive, however fast the trace replays (same mapping
    # as gateway/validate.py, so both entry points stay comparable)
    target = build_target(
        args, device, arena_ttl_s=SimParams().isolate_ttl_s / args.compress)

    tracer = None
    if (args.trace_out is not None or args.trace_sample is not None
            or args.flight_dir is not None):
        flight = FlightRecorder(args.flight_dir) \
            if args.flight_dir is not None else None
        rate = 1.0 if args.trace_sample is None else args.trace_sample
        tracer = Tracer(rate, seed=args.seed, flight=flight)

    cfg = ReplayConfig(compress=args.compress, mem_scale=args.mem_scale,
                       n_workers=args.gw_workers,
                       queue_depth=args.queue_depth,
                       slo_timeout_s=args.slo_timeout,
                       tenant_rate=args.tenant_rate)
    try:
        res, extras = replay_trace(trace, target, cfg, tracer=tracer)
    finally:
        target.shutdown()

    summary = res.summary()
    served = summary["requests"]
    print(f"[gateway] served {served}/{extras['submitted']} requests in "
          f"{extras['wall_s']:.1f}s wall ({extras['registered']} functions "
          f"registered, {extras['late_arrivals']} late submits, "
          f"max lag {extras['max_lag_s'] * 1e3:.0f}ms)")
    print(f"[gateway] drops: {extras['drops']} retries: "
          f"{extras['retries']} autoscaler resizes: "
          f"{extras['autoscaler_resizes']}")
    w = extras["warm"]
    print(f"[gateway] warm-up: {w['warmed']}/{w['caches']} executable "
          f"caches warmed, {sum(w['compiles_before_clock'])} compiles "
          f"before the clock, {extras['exe_cache']['compiles']} at the end"
          + (f"; errors {w['errors'][:3]}" if w["errors"] else ""))
    if "balancer" in extras:
        b = extras["balancer"]
        print(f"[gateway] balancer: armed={b['armed']} "
              f"rebalances={b['rebalances']} moves={b['moves']} "
              f"migrations={b['migrations']} "
              f"transfer={b['transfer_bytes'] / 2**20:.1f}MB/"
              f"{b['transfer_s']:.3f}s")
    if extras["errors"]:
        print(f"[gateway] errors (sample): {extras['errors'][:3]}")
    if tracer is not None:
        ts = tracer.summary()
        print(f"[gateway] tracing: sampled {ts['sampled']}/"
              f"{ts['requests']} requests, "
              f"{sum(ts['anomalies'].values())} anomalies")
        if args.trace_out is not None:
            doc = export_chrome(tracer, args.trace_out,
                                meta={"trace_file": args.trace_file,
                                      "compress": args.compress})
            print(f"[gateway] wrote {len(doc['traceEvents'])} trace "
                  f"events to {args.trace_out} (load in Perfetto or "
                  f"chrome://tracing)")
        if args.flight_dir is not None and "flight" in ts:
            print(f"[gateway] flight recorder: {ts['flight']['dumps']} "
                  f"dump(s) under {args.flight_dir}")
    if args.calibration:
        try:
            write_calibration_doc(args.calibration, calibration_from_replay(
                res, extras, meta={"warm": extras["warm"]}))
            print(f"[gateway] wrote calibration {args.calibration}")
        except ValueError as e:
            # nothing measurable this replay (e.g. every request dropped
            # at the door): report it, don't crash the summary output
            print(f"[gateway] no calibration written: {e}")
    print(json.dumps(summary, indent=1, sort_keys=True, default=str))
    return {**summary, "extras": extras}


def emit_calibration(path, platform, runtimes) -> dict:
    """Map live serving metrics onto the simulator's calibratable
    ``SimParams`` fields and write a hydra-calibration/v1 JSON. Only
    costs this run actually measured are emitted; the simulator keeps
    its paper defaults for the rest."""
    from repro_torch.core.calibrate import write_calibration

    def mean_of(hists, name):
        vals = [h[name].mean for h in hists
                if name in h and h[name].count > 0]
        return float(np.mean(vals)) if vals else None

    plat_hists = []
    if platform is not None:
        plat_hists.append(platform.metrics.hists)
        # a cluster records boot/restore timings on each NODE's platform
        # metrics, not on the cluster-level metrics object
        for node in getattr(platform, "nodes", []):
            plat_hists.append(node.platform.metrics.hists)
    rt_hists = [rt.metrics.hists for rt in runtimes]
    measured = {}
    # arena.alloc_s is NOT mapped onto isolate_cold_s: a short serve run
    # averages the first allocation's one-time costs into that histogram
    for field, value in (
            ("hydra_runtime_cold_s", mean_of(plat_hists, "runtime_boot_s")),
            ("fn_register_s", mean_of(rt_hists, "register_s")),
            ("snapshot_restore_s", mean_of(plat_hists, "restore_s"))):
        if value is not None:
            measured[field] = value
    if not measured:
        print(f"[serve] no measurable costs this run; {path} not written")
        return {}
    doc = write_calibration(path, measured, meta={"source": "serve"})
    print(f"[serve] wrote calibration {path}: {sorted(doc['measured'])}")
    return doc


if __name__ == "__main__":
    main()
