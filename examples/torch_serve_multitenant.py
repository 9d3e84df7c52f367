"""End-to-end driver on the PyTorch/CUDA port: multi-tenant,
multi-architecture LM serving through the Hydra stack — first a
single-node ``HydraPlatform`` (pre-warmed runtime pool, colocation-aware
placement), then a two-node ``HydraCluster`` (cross-node placement +
adaptive pools) — with continuous batching per function.

  PYTHONPATH=src python examples/torch_serve_multitenant.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402

LEG = ["--archs", "qwen2.5-3b,mamba2-780m", "--tenants", "4",
       "--requests", "24", "--slots", "4", "--max-new", "12"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to serve on (default cuda)")
    args = ap.parse_args(argv)
    dev = ["--device", args.device]
    with tempfile.TemporaryDirectory() as snap_dir:
        print("=== single-node HydraPlatform ===")
        serve_main(LEG + ["--pool", "2", "--snapshot-dir", snap_dir] + dev)
    with tempfile.TemporaryDirectory() as snap_dir:
        print("=== two-node HydraCluster ===")
        serve_main(LEG + ["--nodes", "2", "--pool", "1",
                          "--snapshot-dir", snap_dir] + dev)


if __name__ == "__main__":
    main()
