"""Sim-vs-real validation: replay ONE trace through both the live
gateway stack and the discrete-event simulator, and diff the results.

``core/calibrate.py`` closes the loop in one direction (measured costs
flow into the simulator's constants); this harness closes it in the
other: the simulator's *predictions* are checked against the real
``HydraPlatform`` under the identical (thinned) trace. Per-metric
deltas are reported for cold starts, pool claims, p50/p99, memory, and
density. Two gates are enforced:

* **cold starts** — ``|live_cold - sim_cold| <= atol + rtol * sim_cold``
  with ``atol=8``/``rtol=1.0`` by default. Deliberately coarse: live
  timing jitters and the sim packs by per-invocation memory while the
  platform packs by per-function estimate, so exact counts never match —
  but a regression that defeats the warm pool (every request
  cold-booting) blows past any sane tolerance.
* **p99 latency** — ``|live_p99 - sim_p99| <= p99_atol_wall * compress
  + p99_rtol * sim_p99``. Live latencies are recorded in trace seconds
  (wall x compress) while real startup costs do NOT compress with the
  replay clock, so the live p99 carries a compress-amplified startup
  term; the absolute allowance is therefore expressed in *wall* seconds
  (``p99_atol_wall=1.0`` by default) and scaled by ``compress`` so the
  gate means the same thing at any replay speed. A latency regression
  (requests serialized behind a dead pool, a stuck queue) shows up as
  multiple seconds of *wall* divergence and fails at any compression.

**Round trip** (``--round-trip``): the same live replay's
``CalibrationProbe`` payload is turned into a ``hydra-calibration/v1``
overlay (``core.calibrate.calibration_from_replay``), the simulator
re-runs with the measured costs, and the harness asserts the calibrated
sim tracks the live run *at least as closely* as the uncalibrated sim on
cold starts AND p99 — the gateway -> calibration -> sim loop the
simulator's trace-level claims rest on (CI ``roundtrip-smoke``).

The live platform runs on CUDA unless ``run_validation`` is given
``device="cpu"`` (the CLI's ``--device cpu``); with no GPU and no device
it raises rather than fall back to the CPU.

For comparability the live side runs with a FIXED pool (autoscaling
off) sized like the sim model's, no SLO timeout, and no tenant
throttling; the sim side gets ``keepalive_s`` stretched past the trace
horizon because a live platform never expires a placed function.

CLI::

    PYTHONPATH=src python -m repro_torch.gateway.validate \\
        --trace-file benchmarks/data/azure_sample.csv \\
        --target-rps 2 --max-minutes 10 --compress 120 --round-trip

This module is a package (``validate/__init__.py``) rather than
``validate.py`` so that the documentation's bare ``validate.py``
references keep resolving to one file (hydralint HL006).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Optional

from repro_torch.core.calibrate import apply_calibration, calibration_from_replay
from repro_torch.core.metrics import DEFAULT_RESERVOIR
from repro_torch.core.platform import HydraPlatform, PlatformParams
from repro_torch.core.sim import SimParams, simulate
from repro_torch.core.traces import Trace, discover_azure_tables
from repro_torch.core.tracing import Tracer
from repro_torch.gateway.replay import ReplayConfig, replay_trace

# enforced cold-start gate: |live - sim| <= COLD_ATOL + COLD_RTOL * sim
COLD_ATOL = 8
COLD_RTOL = 1.0

# enforced p99 gate: |live - sim| <= P99_ATOL_WALL_S * compress
#                                     + P99_RTOL * sim_p99
# (atol in WALL seconds: live startup does not compress, so its
# trace-time imprint scales with the compression factor). 1.0 wall
# second absorbs scheduler noise on a busy 2-core CI runner (observed
# live p99 jitter is tenths of a wall second) while a regression that
# defeats the warm pool — requests serialized behind inline boots —
# measures multiple wall seconds and still fails at any compression.
P99_ATOL_WALL_S = 1.0
P99_RTOL = 1.0

# round-trip slack: the calibrated sim must be at least as close to live
# as the uncalibrated one, modulo a little integer jitter on cold counts
ROUNDTRIP_COLD_SLACK = 2

# per-metric deltas reported (summary-schema keys)
DELTA_KEYS = ("requests", "dropped", "cold_runtime", "pool_claims",
              "p50_s", "p99_s", "mean_mem_mb", "ops_per_gb_s")


def load_trace(trace_file: Optional[str] = None,
               target_rps: Optional[float] = None,
               max_minutes: Optional[int] = None,
               seed: int = 0, **synthetic_kw) -> Trace:
    """An Azure-format trace (sibling duration/memory tables
    auto-discovered) when ``trace_file`` is given, else the synthetic
    Shahrad-calibrated generator."""
    if trace_file:
        return Trace.from_azure(trace_file,
                                **discover_azure_tables(trace_file),
                                target_rps=target_rps,
                                max_minutes=max_minutes, seed=seed)
    kw = dict(n_functions=24, n_tenants=8, duration_s=120.0, mean_rps=3.0,
              seed=seed)
    kw.update(synthetic_kw)
    return Trace.synthetic(**kw)


def sim_params_for_live(trace, *, pool_size: int,
                        live_runtime_budget: int, mem_scale: float,
                        base: Optional[SimParams] = None) -> SimParams:
    """Map the live platform's configuration onto ``SimParams`` so the
    two replays model the same deployment: same pool target, the
    per-runtime cap un-scaled back to trace bytes, and keep-alive
    stretched past the horizon (a live platform never expires a placed
    function — only idle arenas TTL out)."""
    base = base or SimParams()
    return dataclasses.replace(
        base,
        pool_size=pool_size,
        runtime_cap=max(base.runtime_cap,
                        int(live_runtime_budget / mem_scale)),
        keepalive_s=max(base.keepalive_s, trace.duration_s + 120.0),
    )


def gate(live: float, sim: float, atol: float, rtol: float) -> dict:
    """One ``|live - sim| <= atol + rtol * sim`` tolerance check."""
    limit = atol + rtol * sim
    delta = abs(live - sim)
    return {"live": live, "sim": sim, "delta": delta,
            "atol": atol, "rtol": rtol, "limit": limit,
            "passed": bool(delta <= limit)}


def round_trip_check(live_summary: dict, sim_summary: dict,
                     cal_summary: dict, *,
                     cold_slack: int = ROUNDTRIP_COLD_SLACK) -> dict:
    """Is the calibrated sim at least as close to live as the
    uncalibrated sim, on cold starts AND p99?

    ``cold_slack`` absorbs integer jitter on cold counts (a calibrated
    refill window can shift one boundary boot either way); p99 closeness
    is required outright — the compress-amplified startup term is
    exactly what calibration exists to capture, so losing ground there
    means the round trip is broken."""
    out = {}
    for key, slack in (("cold_runtime", cold_slack), ("p99_s", 0.0)):
        live, un, cal = (live_summary[key], sim_summary[key],
                         cal_summary[key])
        d_un, d_cal = abs(live - un), abs(live - cal)
        out[key] = {"live": live, "uncalibrated": un, "calibrated": cal,
                    "uncal_delta": d_un, "cal_delta": d_cal,
                    "slack": slack,
                    "passed": bool(d_cal <= d_un + slack)}
    out["passed"] = all(out[k]["passed"] for k in ("cold_runtime", "p99_s"))
    return out


def run_validation(trace, *, device=None, compress: float = 60.0,
                   pool_size: int = 4,
                   mem_scale: float = 1.0 / 64,
                   runtime_budget: Optional[int] = None,
                   model: str = "hydra-pool",
                   atol: int = COLD_ATOL, rtol: float = COLD_RTOL,
                   p99_atol_wall: float = P99_ATOL_WALL_S,
                   p99_rtol: float = P99_RTOL,
                   n_workers: int = 8,
                   sim_base: Optional[SimParams] = None,
                   round_trip: bool = False,
                   cold_slack: int = ROUNDTRIP_COLD_SLACK,
                   attribute: bool = False,
                   tracer: Optional[Tracer] = None) -> dict:
    """Replay ``trace`` live and simulated; return the delta report.
    With ``round_trip=True``, additionally derive a calibration from the
    live run itself, re-simulate with it, and gate on the calibrated sim
    tracking live at least as tightly as the uncalibrated sim. With
    ``attribute=True``, span-trace every live request and report which
    phase dominates the latency tail and the cold requests — the
    measured explanation behind any live-vs-sim p99/cold delta; a
    ``tracer`` given with it is the one used, so the caller keeps every
    request's spans."""
    base = sim_base or SimParams()
    live_budget = runtime_budget or max(
        4 << 20, int(base.runtime_cap * mem_scale))
    # isolate TTLs are trace-time semantics: compress them with the
    # replay clock, or idle arenas pin runtime budgets for the entire
    # compressed replay and every burst OOMs
    platform = HydraPlatform(PlatformParams(
        pool_size=pool_size, runtime_budget_bytes=live_budget,
        arena_ttl_s=base.isolate_ttl_s / compress, n_workers=4,
        hist_max_samples=DEFAULT_RESERVOIR, device=device))
    cfg = ReplayConfig(compress=compress, mem_scale=mem_scale,
                       n_workers=n_workers, autoscale=False,
                       slo_timeout_s=None, tenant_rate=None)
    if not attribute:
        tracer = None
    elif tracer is None:
        tracer = Tracer(1.0, seed=0)
    try:
        live, extras = replay_trace(trace, platform, cfg, tracer=tracer)
    finally:
        platform.shutdown()

    params = sim_params_for_live(trace, pool_size=pool_size,
                                 live_runtime_budget=live_budget,
                                 mem_scale=mem_scale, base=base)
    sim = simulate(trace, model, params)

    live_s, sim_s = live.summary(), sim.summary()
    deltas = {}
    for k in DELTA_KEYS:
        lv, sv = live_s.get(k), sim_s.get(k)
        deltas[k] = {"live": lv, "sim": sv,
                     "delta": (lv - sv)
                     if isinstance(lv, (int, float))
                     and isinstance(sv, (int, float)) else None}

    cold = gate(live.cold_runtime_starts, sim.cold_runtime_starts,
                atol, rtol)
    p99 = gate(live_s["p99_s"], sim_s["p99_s"],
               p99_atol_wall * compress, p99_rtol)

    failures = []
    if not live_s["requests"]:
        failures.append("live replay served zero requests")
    if not sim_s["requests"]:
        failures.append("sim replay served zero requests")
    for side, s in (("live", live_s), ("sim", sim_s)):
        for k in ("p50_s", "p99_s", "mean_mem_mb"):
            v = s.get(k)
            if v is None or not math.isfinite(v):
                failures.append(f"{side} {k} is not finite ({v})")
    if not extras.get("drained", True):
        failures.append("gateway did not drain before the timeout")
    err_n = extras.get("drops", {}).get("error", 0)
    if err_n > max(1, 0.01 * len(trace)):
        failures.append(f"{err_n} invoke errors (>1% of the trace): "
                        f"{extras.get('errors', [])[:3]}")
    if not cold["passed"]:
        failures.append(
            f"cold-start divergence {cold['delta']} beyond tolerance "
            f"{cold['limit']:.1f} (live={cold['live']}, sim={cold['sim']}, "
            f"atol={atol}, rtol={rtol})")
    if not p99["passed"]:
        failures.append(
            f"p99 divergence {p99['delta']:.3f}s beyond tolerance "
            f"{p99['limit']:.3f}s (live={p99['live']:.3f}, "
            f"sim={p99['sim']:.3f}, atol={p99_atol_wall:g} wall-s x "
            f"{compress:g}, rtol={p99_rtol:g})")

    report = {
        "trace": trace.describe(),
        "live": live_s, "sim": sim_s, "deltas": deltas,
        "extras": extras,
        # legacy alias for the cold gate (kept so downstream consumers
        # of the report schema keep working)
        "tolerance": {"atol": atol, "rtol": rtol, "limit": cold["limit"],
                      "cold_live": cold["live"], "cold_sim": cold["sim"],
                      "cold_delta": cold["delta"],
                      "passed": cold["passed"]},
        "gates": {"cold_runtime": cold, "p99_s": p99},
    }
    if tracer is not None:
        report["attribution"] = tracer.attribution()

    if round_trip:
        try:
            calibration = calibration_from_replay(live, extras)
        except ValueError as e:
            # a replay that measured nothing (zero requests, everything
            # dropped at the door) must surface as a failure in the
            # report, not a traceback that loses the gate diagnostics
            calibration = None
            failures.append(f"round trip: {e}")
    if round_trip and calibration is not None:
        sim_cal = simulate(trace, model,
                           apply_calibration(params,
                                             calibration["measured"]))
        cal_s = sim_cal.summary()
        rt = round_trip_check(live_s, sim_s, cal_s, cold_slack=cold_slack)
        report["calibration"] = calibration
        report["calibrated_sim"] = cal_s
        report["round_trip"] = rt
        if not rt["cold_runtime"]["passed"]:
            c = rt["cold_runtime"]
            failures.append(
                "round trip: calibrated sim cold starts drifted "
                f"further from live than uncalibrated "
                f"(|{c['live']}-{c['calibrated']}|={c['cal_delta']} vs "
                f"|{c['live']}-{c['uncalibrated']}|={c['uncal_delta']} "
                f"+ slack {c['slack']})")
        if not rt["p99_s"]["passed"]:
            c = rt["p99_s"]
            failures.append(
                "round trip: calibrated sim p99 drifted further from "
                f"live than uncalibrated ({c['cal_delta']:.3f}s vs "
                f"{c['uncal_delta']:.3f}s)")

    report["failures"] = failures
    report["ok"] = not failures
    return report


def format_report(report: dict) -> str:
    def fmt(v):
        if v is None:
            return "-"
        return f"{v:.4f}" if isinstance(v, float) else str(v)

    has_cal = "calibrated_sim" in report
    cal = report.get("calibrated_sim", {})
    header = f"{'metric':>14s} {'live':>12s} {'sim':>12s} {'delta':>12s}"
    if has_cal:
        header += f" {'calibrated':>12s}"
    lines = [header]
    for k, d in report["deltas"].items():
        line = (f"{k:>14s} {fmt(d['live']):>12s} {fmt(d['sim']):>12s} "
                f"{fmt(d['delta']):>12s}")
        if has_cal:
            line += f" {fmt(cal.get(k)):>12s}"
        lines.append(line)
    for name, g in report["gates"].items():
        lines.append(
            f"{name} gate: |{fmt(g['live'])} - {fmt(g['sim'])}| = "
            f"{g['delta']:.4g} <= {g['limit']:.4g} -> "
            f"{'PASS' if g['passed'] else 'FAIL'}")
    if "round_trip" in report:
        rt = report["round_trip"]
        for key in ("cold_runtime", "p99_s"):
            c = rt[key]
            lines.append(
                f"round-trip {key}: calibrated delta {c['cal_delta']:.4g} "
                f"vs uncalibrated {c['uncal_delta']:.4g} "
                f"(slack {c['slack']:g}) -> "
                f"{'PASS' if c['passed'] else 'FAIL'}")
        measured = report["calibration"]["measured"]
        lines.append("calibration: " + ", ".join(
            f"{k}={v:.4g}" for k, v in sorted(measured.items())))
    attr = report.get("attribution")
    if attr:
        for label, key in (("p99 tail", "p99"), ("cold", "cold")):
            g = attr.get(key)
            if not g:
                lines.append(f"attribution {label}: no sampled requests "
                             "in this group")
                continue
            dom = g["dominant"]
            lines.append(
                f"attribution {label}: dominant phase {dom} "
                f"(mean {g['phase_mean_ms'].get(dom, 0.0):.2f}ms wall "
                f"over {g['n']} requests)")
    for f in report["failures"]:
        lines.append(f"FAIL: {f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Replay one trace through the live gateway stack AND "
                    "the simulator; report per-metric deltas and enforce "
                    "the cold-start + p99 tolerances. --round-trip also "
                    "derives a calibration from the live run and checks "
                    "the calibrated sim tracks live at least as tightly.")
    ap.add_argument("--trace-file", default=None,
                    help="Azure Functions 2019-format invocations CSV "
                         "(default: a small synthetic trace)")
    ap.add_argument("--target-rps", type=float, default=None,
                    help="deterministically thin the trace to this mean rps")
    ap.add_argument("--max-minutes", type=int, default=None,
                    help="replay only the first N trace minutes")
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed for synthetic traces and thinning")
    ap.add_argument("--compress", type=float, default=60.0,
                    help="trace seconds replayed per wall second")
    ap.add_argument("--pool", type=int, default=4,
                    help="pre-warmed pool size (live and sim)")
    ap.add_argument("--mem-scale", type=float, default=1.0 / 64,
                    help="trace function memory -> live arena scale")
    ap.add_argument("--model", default="hydra-pool",
                    help="sim model to diff the live replay against")
    ap.add_argument("--workers", type=int, default=8,
                    help="gateway worker threads for the live replay")
    ap.add_argument("--atol", type=int, default=COLD_ATOL,
                    help="cold-start gate absolute allowance (count)")
    ap.add_argument("--rtol", type=float, default=COLD_RTOL,
                    help="cold-start gate relative allowance")
    ap.add_argument("--p99-atol-wall", type=float, default=P99_ATOL_WALL_S,
                    help="p99 gate absolute allowance in WALL seconds "
                         "(scaled by --compress)")
    ap.add_argument("--p99-rtol", type=float, default=P99_RTOL,
                    help="p99 gate relative allowance")
    ap.add_argument("--round-trip", action="store_true",
                    help="derive a calibration from the live replay, "
                         "re-simulate with it, and require the "
                         "calibrated sim to track live at least as "
                         "tightly as the uncalibrated sim")
    ap.add_argument("--attribute", action="store_true",
                    help="span-trace every live request and report the "
                         "phase (queue_wait, pool_claim, register, "
                         "arena_acquire, ...) dominating the latency "
                         "tail and the cold requests")
    ap.add_argument("--emit-calibration", default=None, metavar="PATH",
                    help="with --round-trip: also write the derived "
                         "hydra-calibration/v1 JSON here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the live platform")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    args = ap.parse_args(argv)

    if args.emit_calibration and not args.round_trip:
        print("validate: --emit-calibration requires --round-trip",
              file=sys.stderr)
        return 2

    trace = load_trace(args.trace_file, target_rps=args.target_rps,
                       max_minutes=args.max_minutes, seed=args.seed)
    d = trace.describe()
    print(f"[validate] trace: {d['invocations']} invocations, "
          f"{d['functions']} fns, {d['tenants']} tenants over "
          f"{d['duration_s']:.0f}s (compress {args.compress:g}x -> "
          f"~{d['duration_s'] / args.compress:.1f}s wall)")
    report = run_validation(trace, device=args.device,
                            compress=args.compress,
                            pool_size=args.pool, mem_scale=args.mem_scale,
                            model=args.model, n_workers=args.workers,
                            atol=args.atol, rtol=args.rtol,
                            p99_atol_wall=args.p99_atol_wall,
                            p99_rtol=args.p99_rtol,
                            round_trip=args.round_trip,
                            attribute=args.attribute)
    print(format_report(report))
    if args.emit_calibration and "calibration" in report:
        from repro_torch.core.calibrate import write_calibration_doc
        write_calibration_doc(args.emit_calibration, report["calibration"])
        print(f"[validate] wrote calibration {args.emit_calibration}")
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True, default=str))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
