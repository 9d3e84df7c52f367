#!/usr/bin/env python3
"""The readings a cell's limits are set from (``limits/<cell>.json``), on
the card, at the cell's own size and load, in one process:

    python3 portbench/readings.py --workload <cell> --seeds 12 \\
        --controls 3 --seconds 8 --out readings-<cell>.json

For each of ``--seeds`` seeds, a run of the cell with a window of
``--seconds`` and its compared numbers (the program's readings: the lower
ones). For the first ``--controls`` of them, the control: the reference
computed with fp8 products (the step below the served bf16) at the same
prompts and served tokens, read as the float32 reference's gap of the
token the fp8 one puts first; and the fault ``altered_token`` (a run).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                str(Path(__file__).resolve().parent.parent / "src")]

from portbench import run as runner  # noqa: E402

SEED0 = 2_718_281_828


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def serve_control(registry, cfg, seed, sample, device) -> float:
    """Widest float32-reference gap of the token the fp8 reference puts
    first, over the sample's positions."""
    import torch
    from portbench import weights
    from portbench.drivers.serving import gaps_of, reference_logits
    params = weights.make(registry, cfg, seed, torch.bfloat16, device)
    worst = 0.0
    for r in sample:
        ref = reference_logits(registry, cfg, params, r, device)
        low = reference_logits(registry, cfg, params, r, device, "fp8")
        worst = max(worst, float(gaps_of(ref, low.argmax(-1)).max()))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--first-seed", type=int, default=SEED0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    runner.environment()
    import torch
    torch.set_num_threads(1)
    from portbench import faults
    from portbench.registry import Registry

    registry = Registry()
    device = torch.device("cuda", 0)
    w = registry.workload(args.workload)
    cfg = registry.config(w["config"])
    out = {"workload": args.workload, "card": runner.card(), "runs": [],
           "controls": [], "faults": []}

    def save():
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))

    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t = time.perf_counter()
        res, rec = runner.run_cell(registry, args.workload, seed,
                                   args.seconds, False, device, t)
        row = {"seed": seed, "correct": res["correct"],
               "checks": {k: v["value"] for k, v in rec.checks.items()},
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "setup": rec.setup_parts, "check_s": rec.check_s,
               "wall_s": time.perf_counter() - t}
        out["runs"].append(row)
        log(f"[readings] run {json.dumps(row)}")
        if i < args.controls:
            c = {"token_gap": serve_control(registry, cfg, seed,
                                            rec.extra["sample"], device)}
            out["controls"].append({"seed": seed, "checks": c})
            log(f"[readings] control {seed} {c}")
        del rec
        save()
    for i in range(args.controls):
        seed = args.first_seed + 7919 * i
        with faults.altered_token(cfg["vocab_size"]):
            res, rec = runner.run_cell(registry, args.workload, seed,
                                       args.seconds, False, device,
                                       time.perf_counter())
        row = {"fault": "altered_token", "seed": seed,
               "correct": res["correct"],
               "checks": {k: v["value"] for k, v in rec.checks.items()}}
        out["faults"].append(row)
        log(f"[readings] fault {json.dumps(row)}")
        del rec
        save()
    out["wall_s"] = time.perf_counter() - T_START
    save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
