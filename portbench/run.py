#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it is started
on, and print its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``) and a mix (``traffic/<mix>.json``), whose
``kind`` names the driver (``drivers/<kind>.py``). With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones and the device trace's busy time; each metric is read by
``metrics/<metric>.py``. Set-up parts, the compared numbers beside their
limits and the card's name and power limit go to standard error.

Exit codes: 0 with a result; 2 without a card, with fewer cards than the
cell asks for, or outside a checkout of the repository; 3 when JAX or the
JAX package was loaded; 1 on any other error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()     # set-up counts from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a cell's first run in it builds; one host thread for
    PyTorch's and OpenMP's CPU work, so the run's load is one thread."""
    base = ROOT / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (the loaded modules
    by default), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def written_bytes() -> str:
    """What this process has written to storage (``/proc/self/io``)."""
    try:
        io = dict(line.split(": ") for line in
                  Path("/proc/self/io").read_text().splitlines())
        return f"write_bytes {io['write_bytes']}, wchar {io['wchar']}"
    except (OSError, KeyError, ValueError):
        return "not readable"


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def run_cell(registry, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float = T_START):
    """Drive one run of ``workload`` on ``device`` and read its metrics:
    (result dict, record). Looks for no card itself."""
    from portbench.record import Context
    w = registry.workload(workload)
    cfg = registry.config(w["config"])
    mix = registry.mix(w["traffic"])
    ctx = Context(registry=registry, cfg=cfg, mix=mix,
                  limits=registry.limits(workload),
                  seed=seed & ((1 << 63) - 1), seconds=seconds, trace=trace,
                  device=device, t_start=t_start)
    rec = registry.module("drivers", mix["kind"]).run(ctx)
    metrics = {}
    for m in registry.metrics(workload, trace):
        value = registry.reader(m["name"])(rec)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = rec.checks
    correct = rec.failed == 0 and all(c["value"] <= c["limit"]
                                      for c in checks.values())
    result = {"correct": bool(correct), "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics}
    return result, rec


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"no src/repro_torch under {ROOT}: not a checkout of the "
            f"repository")
        return 2
    environment()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    torch.set_num_threads(1)
    from portbench.registry import Registry

    registry = Registry()
    chips = registry.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" visible")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    result, rec = run_cell(registry, args.workload, args.seed, args.seconds,
                           bool(args.trace), device)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {found} (the port's benchmark loads "
            f"no JAX and no JAX package)")
        return 3
    result["device"] = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": chips, "memory_peak_bytes": rec.peak_mem_bytes}
    if args.trace:
        from portbench import trace
        result["device"]["busy_s"] = trace.busy_s(rec.kernels, rec.t0,
                                                  rec.t1)
        result["device"]["window_s"] = rec.window_s
        result["breakdown"] = trace.breakdown(rec.kernels, rec.spans,
                                              rec.t0, rec.t1)
    # strict JSON: a number that is not finite (no sample to compare)
    # is written as null; ``correct`` is false then
    result["checks"] = {
        k: {"value": v["value"] if math.isfinite(v["value"]) else None,
            "limit": v["limit"]} for k, v in rec.checks.items()}
    log(f"[card] {card()}")
    log(f"[io] {written_bytes()}")
    log("[setup] " + json.dumps({"setup_s": rec.setup_s,
                                 **rec.setup_parts}))
    log("[host] " + json.dumps(rec.host))
    log(f"[window] {rec.window_s:.3f} s, {len(rec.window_steps())} steps, "
        f"{rec.attempted} attempted, {rec.failed} failed; the check "
        f"{rec.check_s:.3f} s")
    for k, v in rec.checks.items():
        extra = f" ({v['leaf']})" if "leaf" in v else ""
        log(f"[check] {k} {v['value']!r} limit {v['limit']!r}{extra}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
