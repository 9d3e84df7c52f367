"""End-to-end training driver on the PyTorch/CUDA port: train a reduced
qwen-family model for a few hundred steps with checkpointing + an
injected node failure at step 120 (restore + resume), demonstrating the
fault-tolerance path.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
      [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300,
                    help="training steps to run (default: 300)")
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help="model architecture preset (default: qwen2.5-3b)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to train on (default cuda)")
    args = ap.parse_args()
    ckpt = tempfile.mkdtemp(prefix="hydra_train_ck_")
    # reduced qwen2.5 config (~2M params); scale dims up with the
    # launcher's --full
    train_main(["--arch", args.arch, "--reduced",
                "--steps", str(args.steps),
                "--batch", "8", "--seq", "128",
                "--n-micro", "2", "--remat",
                "--ckpt-dir", ckpt, "--ckpt-every", "25",
                "--fail-at", str(min(120, args.steps // 2 + 10)),
                "--device", args.device])
    print(f"checkpoints in {ckpt}")
