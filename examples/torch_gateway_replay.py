"""Live gateway replay on the PyTorch/CUDA port: the real Hydra stack
under trace traffic, on the wall clock — and the same trace through the
simulator, side by side.

The discrete-event simulator (``examples/torch_trace_replay.py``)
*projects* how the platform behaves under the Azure workload; this
example *measures* it: every invocation in the (thinned) trace becomes a
real request through ``repro_torch.gateway`` — per-tenant bounded
queues, a real ``HydraPlatform`` with a pre-warmed pool on the device,
real placement, real arena allocation, real programs — replayed
open-loop at a wall-clock compression factor. The run finishes with the
live-vs-sim delta table, in **round-trip** mode: the replay's own
CalibrationProbe measurements are folded back into ``SimParams`` and the
calibrated simulator must track the live run at least as tightly as the
paper-constant one. It exits 1 when a gate fails.

  PYTHONPATH=src python examples/torch_gateway_replay.py [azure_trace.csv]
      [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.gateway import (format_report, load_trace,  # noqa: E402
                                 run_validation)

COMPRESS = 120.0          # trace seconds per wall second
SAMPLE = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "benchmarks", "data",
    "azure_sample.csv"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", nargs="?", default=SAMPLE,
                    help="Azure-format invocations CSV (default: the "
                         "bundled sample)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the platform's runtimes (default cuda)")
    args = ap.parse_args(argv)
    if not os.path.exists(args.trace):
        sys.exit(f"trace file not found: {args.trace}")
    # thin to CI-friendly volume; the arrival SHAPE (bursts, idle gaps)
    # is preserved by the seeded-binomial thinning of the trace loader
    trace = load_trace(args.trace, target_rps=2.0, max_minutes=10)
    d = trace.describe()
    print(f"trace: {d['invocations']} invocations, {d['functions']} fns, "
          f"{d['tenants']} tenants over {d['duration_s']:.0f}s "
          f"(~{d['duration_s'] / COMPRESS:.1f}s wall at {COMPRESS:g}x)\n")

    report = run_validation(trace, device=args.device, compress=COMPRESS,
                            pool_size=4, round_trip=True)
    live = report["live"]
    print(f"live gateway: {live['requests']} served, "
          f"{live['cold_runtime']} cold starts, "
          f"{live['pool_claims']} pool claims, "
          f"p50={live['p50_s']:.2f}s p99={live['p99_s']:.2f}s "
          f"(trace time; startup is compress-amplified)\n")
    print(format_report(report))
    calibration = report.get("calibration")
    if calibration:
        measured = calibration["measured"]
        print(f"\nderived calibration ({len(measured)} fields): "
              + ", ".join(sorted(measured)))
    if not report["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
