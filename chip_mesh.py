#!/usr/bin/env python3
"""The train launcher on one card and on a mesh of four, at full width.

    python3 chip_mesh.py          # on a host with four CUDA devices

Full-width qwen2.5-3b takes 3 steps (batch 8 x seq 128, the seeded init
and data of ``chip_smoke.py``'s phase 5b) through
``repro_torch.launch.train`` three times: ``--data-model 1,1`` on one card
(plain tensors), then ``2,2`` and ``4,1`` on four (one process per rank,
an nccl group on a ``tcp://localhost`` address; params and batch placed as
DTensors on the FSDP rules, the kernels on each rank's shards). Per rank
it records the losses, the host ms of each step, the kernel launches,
the ops ``on_mesh`` resharded and ``max_memory_allocated``. Gates: every
rank of a mesh gives the same losses, within 2e-3 of the one-card run's;
73 rmsnorm and 36 flash attention launches a step each way on every
rank; nothing resharded. Output: the card's name and power limit, a
line per rank, then one JSON object; the same goes to
``chiprun_out/chip_mesh.json``.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
ARGV = ["--arch", "qwen2.5-3b", "--full", "--steps", "3", "--batch", "8",
        "--seq", "128", "--lr", "1e-3", "--warmup", "3"]
MESHES = (("1,1", 1), ("2,2", 4), ("4,1", 4))


def rank_main(dm: str, rank: int, world: int, port: str) -> None:
    """One rank of one mesh: the launcher's run, its numbers as JSON."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.launch import train
    if world > 1:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world,
                                device_id=torch.device("cuda", rank))
    counters = cs.zero_launches()
    torch.cuda.reset_peak_memory_stats()
    run = train.run(train.parse_args(ARGV + ["--data-model", dm]))
    torch.cuda.synchronize()
    print("RESULT " + json.dumps(dict(
        dm=dm, rank=rank, mesh=str(run["mesh"]), placed=run["placed"],
        losses=run["losses"], step_ms=run["step_ms"],
        reshards=run["reshards"],
        launches={n: fn.launches for n, fn in counters.items()},
        max_memory_allocated=torch.cuda.max_memory_allocated())),
        flush=True)
    if world > 1:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_mesh(dm: str, world: int) -> list:
    """Every rank of one mesh in a process of its own; a rank that fails
    fails the script."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", dm, str(r), str(world),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT) for r in range(world)]
    try:
        outs = [p.communicate(timeout=420) for p in procs]
    finally:
        for p in procs:
            p.kill()
    results = []
    for p, (out, err) in zip(procs, outs):
        line = [x for x in out.splitlines() if x.startswith("RESULT ")]
        if p.returncode != 0 or not line:
            raise SystemExit(f"chip_mesh: a rank of {dm} failed "
                             f"({p.returncode}):\n{out[-2000:]}\n"
                             f"{err[-4000:]}")
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    need = max(world for _, world in MESHES)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"chip_mesh: needs {need} CUDA devices", file=sys.stderr)
        return 1
    card = cs.nvidia_smi()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()          # once, before the ranks load the libraries
    print(f"[build] {time.perf_counter() - t0:.1f}s", flush=True)
    want = cs.train_launches(get_config("qwen2.5-3b"))
    steps = int(ARGV[ARGV.index("--steps") + 1])
    results, base = [], None
    for dm, world in MESHES:
        t0 = time.perf_counter()
        ranks = run_mesh(dm, world)
        for r in ranks:
            r["mesh_s"] = time.perf_counter() - t0
            print(f"[{dm}] rank {r['rank']}: losses {r['losses']}, step ms "
                  f"{[round(x, 1) for x in r['step_ms']]}, launches "
                  f"{r['launches']}, resharded {r['reshards']}, "
                  f"max_memory_allocated "
                  f"{r['max_memory_allocated'] / 1e9:.2f} GB", flush=True)
            if r["losses"] != ranks[0]["losses"]:
                raise SystemExit(f"chip_mesh: {dm}: ranks disagree")
            if base is not None:
                np.testing.assert_allclose(r["losses"], base, rtol=2e-3)
            for name, n in want.items():
                if r["launches"][name] != n * steps:
                    raise SystemExit(f"chip_mesh: {dm} rank {r['rank']}: "
                                     f"{r['launches'][name]} {name} "
                                     f"launches, want {n * steps}")
            if r["reshards"]:
                raise SystemExit(f"chip_mesh: {dm}: resharded "
                                 f"{r['reshards']}")
        base = base or ranks[0]["losses"]
        results += ranks
    out = {"card": card, "runs": results}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_mesh.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
        sys.exit(0)
    sys.exit(main())
