"""End-to-end training driver with checkpoint/restart, failure injection,
straggler detection, elastic restore and optional gradient compression: a
port of ``repro/launch/train.py``, with the same flags and defaults.

It runs on CUDA unless ``--device cpu`` is given. The port has one device
and no mesh or sharding yet, so ``--data-model`` takes only ``1,1``. The
weights are the port's own seeded init (fp32 masters; the forward
computes in the config's dtype). The step updates params and optimizer
state in place, as the reference's donated step does. On the card the
forward and backward of ``rmsnorm``, ``flash_attention`` and ``ssd_scan``
are hand-written kernels, so every family trains there.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ck
  # node-failure drill: inject a failure, watch restore+resume
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --reduced --steps 18 --batch 2 --seq 32 --fail-at 12 \\
      --ckpt-dir /tmp/ck2 --ckpt-every 5
  # full width on the card
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 8
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.compression import ErrorFeedbackCompression
from repro_torch.ft.failures import (FailureInjector, HeartbeatMonitor,
                                     InjectedFailure)
from repro_torch.models.programs import ModelProgram
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.optim.adamw import tree_map


def build(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    prog = ModelProgram(cfg, remat=args.remat)
    opt = AdamW(lr=warmup_cosine(args.lr, args.warmup, args.steps))
    if args.compress:
        opt = ErrorFeedbackCompression(opt)
    return cfg, prog, opt


def make_batch(cfg, args, step: int, host_batch: dict, device) -> dict:
    """The data step's tokens/labels on ``device``; audio and vlm batches
    draw their embeddings from a ``torch.Generator`` seeded with the step,
    as the reference draws them from ``PRNGKey(step)``."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in host_batch.items()}
    if cfg.family not in ("audio", "vlm"):
        return batch
    n = args.seq if cfg.family == "audio" else cfg.frontend_tokens
    gen = torch.Generator(device=device).manual_seed(step)
    embeds = torch.randn((args.batch, n, cfg.d_model), generator=gen,
                         device=device).to(torch_dtype(cfg.dtype))
    if cfg.family == "audio":
        return {"embeds": embeds, "labels": batch["labels"] % cfg.vocab_size}
    return {"embeds": embeds, "tokens": batch["tokens"][:, :args.seq - n],
            "labels": batch["labels"]}


def meta_like(tree):
    """The tree's shapes and dtypes as meta tensors (no memory): a restore
    template that lets the live state be freed before the restore."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help="model architecture to train")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the reduced config (default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="use the full-size config instead of --reduced")
    ap.add_argument("--steps", type=int, default=50,
                    help="optimizer steps to run")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch size")
    ap.add_argument("--seq", type=int, default=128,
                    help="sequence length")
    ap.add_argument("--n-micro", type=int, default=1,
                    help="microbatches per step (gradient accumulation)")
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="peak learning rate")
    ap.add_argument("--warmup", type=int, default=10,
                    help="linear warmup steps")
    ap.add_argument("--ckpt-dir", default=None,
                    help="write checkpoints under this directory")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="checkpoint interval in steps")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (restart drill)")
    ap.add_argument("--compress", action="store_true",
                    help="wrap the optimizer in error-feedback compression")
    ap.add_argument("--remat", action="store_true",
                    help="enable rematerialization (activation ckpting)")
    ap.add_argument("--data-model", default="1,1",
                    help="local mesh shape data,model (only 1,1: one device)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to train on (default cuda)")
    args = ap.parse_args(argv)
    if [x.strip() for x in args.data_model.split(",")] != ["1", "1"]:
        raise ValueError(f"--data-model {args.data_model}: mesh shapes are "
                         f"not ported yet; the port trains on one device "
                         f"(1,1)")
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg, prog, opt = build(args)
    monitor = HeartbeatMonitor()
    injector = FailureInjector(
        fail_at_steps=(args.fail_at,) if args.fail_at else ())

    params = prog.init(0, device=device)
    opt_state = opt.init(params)
    step_fn = prog.make_train_step(opt, n_micro=args.n_micro)

    start_step = 0
    writer = None
    if args.ckpt_dir:
        writer = ckpt.AsyncCheckpointer(args.ckpt_dir)
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            meta = meta_like({"params": params, "opt": opt_state})
            del params, opt_state
            state = ckpt.restore(args.ckpt_dir, last, meta, device=device)
            params, opt_state = state["params"], state["opt"]
            start_step = last + 1
            print(f"[train] resumed from step {last}")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          batch_size=args.batch)
    pf = Prefetcher(data_cfg, start_step=start_step)
    losses = []
    t_start = time.perf_counter()
    step = start_step
    try:
        while step < args.steps:
            dstep, host_batch = pf.next()
            assert dstep == step, (dstep, step)
            batch = make_batch(cfg, args, step, host_batch, device)
            try:
                injector.check(step)
                params, opt_state, mets = step_fn(params, opt_state, batch)
            except InjectedFailure as e:
                print(f"[train] FAILURE: {e}")
                if not args.ckpt_dir:
                    raise
                if writer:
                    writer.wait()
                last = ckpt.latest_step(args.ckpt_dir)
                assert last is not None, "no checkpoint to restore"
                # elastic restore onto the (possibly new) device
                meta = meta_like({"params": params, "opt": opt_state})
                del params, opt_state
                state = ckpt.restore(args.ckpt_dir, last, meta, device=device)
                params, opt_state = state["params"], state["opt"]
                pf.close()
                step = last + 1
                pf = Prefetcher(data_cfg, start_step=step)
                print(f"[train] restored step {last}, resuming at {step}")
                continue
            monitor.beat("worker0")
            loss = float(mets["loss"])
            losses.append(loss)
            if step % 5 == 0 or step == args.steps - 1:
                dt = time.perf_counter() - t_start
                print(f"[train] step {step:4d} loss {loss:7.4f} "
                      f"gnorm {float(mets.get('grad_norm', 0)):6.3f} "
                      f"({dt:5.1f}s)", flush=True)
            if writer and step % args.ckpt_every == 0:
                writer.save_async(step, {"params": params, "opt": opt_state})
            step += 1
    finally:
        pf.close()
        if writer:
            writer.wait()
    print(f"[train] done: first loss {losses[0]:.4f} "
          f"last loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
