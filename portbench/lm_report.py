#!/usr/bin/env python3
"""``lm_trace.py``'s one traced run and report, with what the published
Zamba2 block adds to the program's records: the ``shared`` spans (one per
shared-block invocation, attributes ``block`` and ``invocation``), the
attention kernels' ``head_dim`` on their ``kernel`` spans, and the
runtime's ``lm_slab_bytes.<kind>`` counters (the function's slab by kind:
kv, ssm_state, conv), recorded at registration. A program without them
gives empty entries::

    python3 portbench/lm_report.py --workload zamba2-docs --seed 7 \\
        --seconds 50
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def program_records(lm, counters: dict) -> dict:
    """The shared spans by block and invocation, the window's decode
    forwards by how they ran (eager, capture, replay), the attention
    kernels' head dims, and the slab bytes by kind."""
    spans = [s for _, sps in (lm or {}).get("steps", []) for s in sps]
    shared = [s for s in spans if s[0] == "shared"]
    by_block: dict = {}
    by_invocation: dict = {}
    for _, a, b, at in shared:
        at = at or {}
        k = str(at.get("block"))
        by_block[k] = by_block.get(k, 0.0) + (b - a)
        j = str(at.get("invocation"))
        by_invocation[j] = by_invocation.get(j, 0) + 1
    graph: dict = {}
    for s in spans:
        if s[0] == "decode.forward":
            how = str((s[3] or {}).get("graph"))
            graph[how] = graph.get(how, 0) + 1
    heads: dict = {}
    for s in spans:
        at = s[3] or {}
        if s[0] == "kernel" and "head_dim" in at:
            heads.setdefault(at["name"], set()).add(at["head_dim"])
    return {
        "shared_spans": len(shared),
        "shared_wall_s_by_block": by_block,
        "shared_spans_by_invocation": by_invocation,
        "attention_head_dims": {k: sorted(v) for k, v in heads.items()},
        "window_decode_forwards_by_graph": graph,
        "slab_bytes": {k.split(".", 1)[1]: v for k, v in counters.items()
                       if k.startswith("lm_slab_bytes.")},
    }


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root), str(root / "src")]
    from portbench import run as runner
    runner.environment()
    import torch
    torch.set_num_threads(1)
    from repro_torch.core.runtime import HydraRuntime

    from portbench import lm_trace
    from portbench.drivers import serving
    from portbench.registry import Registry
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    trace_cls = lm_trace._launch_trace_class()
    serving.DeviceTrace = trace_cls
    runtimes = []
    register = HydraRuntime.register_function

    def kept(self, *a, **kw):        # the run's runtime, for its counters
        runtimes.append(self)
        return register(self, *a, **kw)

    HydraRuntime.register_function = kept
    res, rec = runner.run_cell(Registry(), args.workload, args.seed,
                               args.seconds, True, device,
                               time.perf_counter())
    lt = trace_cls.last
    counters = dict(runtimes[0].metrics.counters) if runtimes else {}
    out = {"result": res, "card": runner.card(),
           **lm_trace.report(rec, lt.launches if lt else [],
                             lt.drift_s if lt else None,
                             lt.device_allocs if lt else None),
           "program_records": program_records(lm_trace.of(rec), counters),
           "decode_graph": {k: v for k, v in counters.items()
                            if k.startswith("decode_graph.")}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
