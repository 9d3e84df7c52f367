"""Render the port's dry-run roofline JSONs into tables: a port of
``benchmarks/roofline_table.py``, reading ``experiments/dryrun_torch/``
(``launch/dryrun``'s records), never the reference's
``experiments/dryrun/``.

  PYTHONPATH=src python -m repro_torch.launch.roofline_table [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import OUT

MOVE = {
    "compute": "more useful-FLOP fraction (less remat/masked-attention "
               "waste) or lower precision",
    "memory": "fewer cache/activation passes (windowed KV reads, fused "
              "update-in-place, bf16 end-to-end)",
    "collective": "cheaper parallelism layout (less TP for small models, "
                  "sequence-parallel TP, bf16 reduce-scatter gradients)",
}


def load(mesh: str, tag: str = "", root: str = OUT) -> list:
    rows = []
    for p in sorted(glob.glob(os.path.join(root, "*.json"))):
        with open(p) as f:
            d = json.load(f)
        if d["mesh"] != mesh or d.get("tag", "") != tag:
            continue
        rows.append(d)
    rows.sort(key=lambda d: (d["arch"], d["shape"]))
    return rows


def render(rows: list) -> str:
    out = ["| arch | shape | t_compute | t_memory | t_collective | bound | "
           "MODEL_FLOPS | useful | roofline | fit GB/dev |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        r = d["roofline"]
        out.append(
            f"| {d['arch']} | {d['shape']} | {r['t_compute_s']:.4f}s | "
            f"{r['t_memory_s']:.4f}s | {r['t_collective_s']:.4f}s | "
            f"**{r['bottleneck'][:4]}** | {d['model_flops']:.2e} | "
            f"{d['useful_flops_frac']:.2f} | {d['roofline_frac']:.3f} | "
            f"{d['hbm_fit_bytes']/2**30:.2f} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16",
                    help="mesh shape whose dryrun cells to tabulate")
    ap.add_argument("--tag", default="",
                    help="optional result-set tag suffix to load")
    ap.add_argument("--dir", default=OUT,
                    help="directory of the dry-run's JSON records")
    args = ap.parse_args(argv)
    rows = load(args.mesh, args.tag, args.dir)
    print(f"### Roofline table — mesh {args.mesh} ({len(rows)} cells)\n")
    print(render(rows))
    print("\nPer-cell dominant-term notes:")
    for d in rows:
        r = d["roofline"]
        print(f"- **{d['arch']} x {d['shape']}** ({r['bottleneck']}-bound): "
              f"{MOVE[r['bottleneck']]}.")
    return rows


if __name__ == "__main__":
    main()
