#!/usr/bin/env python3
"""Device times of two checkouts' rmsnorm and ssd_scan kernels on one
card, in turns, so that a redesign is compared with the design before it
in the same run.

    python3 chip_ab.py OTHER_CHECKOUT

Each turn is a process of its own that imports ``repro_torch`` from one
checkout, builds that checkout's kernels (into its own
``src/repro_torch/kernels/build/``) and times its public wrappers at
chip_smoke.py's serving shapes, on the same seeded inputs: rmsnorm (bf16)
at the decode rows of qwen2.5-3b, zamba2-2.7b and mamba2-780m and at a
500-token prompt, beside ``F.rms_norm``; ssd_scan (bf16, chunk 256, final
state) at zamba2-2.7b's and mamba2-780m's 500-token prefill. Each time is
the torch.profiler device time of one call (chip_smoke.device_ms), and
for rmsnorm also the CUDA-events time per call over back-to-back calls.
The turns run other, this, this, other, so a drift of the card between
them shows. Output: the card's name and power limit, then one JSON object
with every turn; the same goes to ``chiprun_out/chip_ab.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def worker(checkout: str) -> dict:
    import chip_smoke as cs                    # puts ROOT/src on the path
    sys.path.insert(0, os.path.join(os.path.abspath(checkout), "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    out = {"checkout": os.path.abspath(checkout), "rmsnorm": {},
           "ssd_scan": {}}
    for shape in [(4, 1, cs.QWEN["D"]), (4, 1, cs.ZAMBA["D"]),
                  (4, 1, cs.MAMBA["D"]), (1, 500, cs.QWEN["D"])]:
        D = shape[-1]
        x = cs.randn(shape, bf16, gen)
        w = (cs.randn((D,), torch.float32, gen) * 0.1).to(bf16)
        w1 = (1.0 + w.float()).to(bf16)
        kern = lambda: rmsnorm(x, w)
        lib = lambda: F.rms_norm(x, (D,), w1, 1e-5)
        out["rmsnorm"][str(shape)] = dict(
            device_ms=cs.device_ms(kern), library_device_ms=cs.device_ms(lib),
            events_ms=cs.cuda_ms(kern, iters=300),
            library_events_ms=cs.cuda_ms(lib, iters=300))
    for name, m in (("zamba2", cs.ZAMBA), ("mamba2", cs.MAMBA)):
        args = cs.ssd_inputs(gen, 1, 500, m["H"], m["P"], m["N"], bf16,
                             strided=True)
        out["ssd_scan"][name] = dict(
            shape=[1, 500, m["H"], m["P"]], N=m["N"],
            device_ms=cs.device_ms(lambda: ssd_scan(
                *args, chunk=cs.SSD_CHUNK, return_state=True)))
    return out


def main(argv: list) -> int:
    if len(argv) == 2 and argv[0] == "--worker":
        print(json.dumps(worker(argv[1])))
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device visible", file=sys.stderr)
        return 1
    card = cs.nvidia_smi()
    print(card, flush=True)
    turns = []
    for tag, checkout in (("other", argv[0]), ("this", ROOT), ("this", ROOT),
                          ("other", argv[0])):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", checkout], capture_output=True,
                             text=True, timeout=900)
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append(dict(turn=tag, **json.loads(
            res.stdout.strip().splitlines()[-1])))
        print(json.dumps(turns[-1]), flush=True)
    report = {"card": card, "turns": turns}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_ab.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
