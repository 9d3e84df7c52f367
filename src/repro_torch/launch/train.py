"""End-to-end training driver with checkpoint/restart, failure injection,
straggler detection, elastic restore and optional gradient compression: a
port of ``repro/launch/train.py``, with the same flags and defaults.

It runs on CUDA unless ``--device cpu`` is given. ``--data-model d,m``
builds the reference's mesh (``make_local_mesh``: ``d`` clamped to the
visible devices, ``m`` not, so a mesh larger than them raises) and its
FSDP rules (``default_rules(mesh, fsdp=True)``). On a mesh of more than
one device the params are placed on their DTensor shardings
(``named_sharding_tree`` + ``place``), the optimizer state follows them,
each batch is split over the batch axes, and the step runs under
``on_mesh``, whose resharded ops the launcher prints after the first
step. A mesh of one device splits nothing (every placement there holds
the whole tensor), so the leaves stay plain tensors on it: the same
layout without DTensor's dispatch on every op. The launcher prints the
mesh and the placements it resolved. The weights are the port's own
seeded init (fp32 masters; the forward
computes in the config's dtype). The step updates params and optimizer
state in place, as the reference's donated step does. On the card the
forward and backward of ``rmsnorm``, ``flash_attention`` and ``ssd_scan``
are hand-written kernels, run on each rank's shards, so every family
trains there.

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
import collections
import contextlib
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.device import is_dtensor, resolve_device, torch_dtype
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.compression import ErrorFeedbackCompression
from repro_torch.ft.failures import (FailureInjector, HeartbeatMonitor,
                                     InjectedFailure)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.sharding import (NamedSharding, batch_sharding,
                                         default_rules, named_sharding_tree,
                                         on_mesh, place, use_rules)
from repro_torch.models.programs import ModelProgram
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.optim.adamw import tree_leaves, tree_map


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


def shardings_of(tree):
    """The ``NamedSharding`` of every DTensor leaf of ``tree`` (None for a
    plain one, such as the optimizer's step): where an elastic restore
    puts it back."""
    return tree_map(lambda t: NamedSharding(t.device_mesh,
                                            tuple(t.placements))
                    if is_dtensor(t) else None, tree)


def placement_counts(shardings) -> dict:
    """{placements: leaves} of a tree of ``NamedSharding``s, for the
    launcher's report."""
    return dict(collections.Counter(
        "(" + ", ".join(str(p) for p in sh.placements) + ")"
        for sh in tree_leaves(shardings)))


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
                    help="local mesh shape data,model")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to train on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))["losses"]


def run(args) -> dict:
    """The launcher's run of parsed ``args``: {"losses", "step_ms" (host
    ms of each step, ending in the loss's read), "mesh", "rules",
    "pshard" (the params' resolved shardings), "placed" (whether the
    leaves are DTensors: a mesh of more than one device), "reshards" (the
    ops ``on_mesh`` resharded, summed over the steps), "params",
    "opt_state", "step_fn"}, the last three as the run left them."""
    device = resolve_device(args.device)
    cfg, prog, opt = build(args)
    dm = [int(x) for x in args.data_model.split(",")]
    mesh = make_local_mesh(dm[0], dm[1], device_type=device.type)
    rules = default_rules(mesh, fsdp=True)
    monitor = HeartbeatMonitor()
    injector = FailureInjector(
        fail_at_steps=(args.fail_at,) if args.fail_at else ())

    with use_rules(rules):
        params = prog.init(0, device=device)
        pshard = named_sharding_tree(params, rules, cfg)
        placed = mesh.size() > 1
        if placed:
            params = place(params, pshard)
        opt_state = opt.init(params)
        state = {"params": params, "opt": opt_state}
        # where an elastic restore puts each leaf back (the device, on a
        # mesh of one), and its shape
        shardings = shardings_of(state) if placed else None
        template = meta_like(state)
        del state
        print(f"[train] mesh {mesh}; leaves by placements "
              f"{placement_counts(pshard)}"
              + ("" if placed else "; one device: plain tensors"),
              flush=True)
        step_fn = prog.make_train_step(opt, n_micro=args.n_micro)

        def restore(step: int):
            return ckpt.restore(args.ckpt_dir, step, template,
                                shardings=shardings, device=device)

        start_step = 0
        writer = None
        if args.ckpt_dir:
            writer = ckpt.AsyncCheckpointer(args.ckpt_dir)
            last = ckpt.latest_step(args.ckpt_dir)
            if last is not None:
                del params, opt_state
                state = restore(last)
                params, opt_state = state["params"], state["opt"]
                start_step = last + 1
                print(f"[train] resumed from step {last}")

        data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              batch_size=args.batch)
        pf = Prefetcher(data_cfg, start_step=start_step)
        losses, step_ms = [], []
        reshards = collections.Counter()
        t_start = time.perf_counter()
        step = start_step
        try:
            while step < args.steps:
                dstep, host_batch = pf.next()
                assert dstep == step, (dstep, step)
                batch = make_batch(cfg, args, step, host_batch, device)
                if placed:
                    batch = place(batch, batch_sharding(mesh, batch))
                t_step = time.perf_counter()
                try:
                    injector.check(step)
                    with (on_mesh() if placed
                          else contextlib.nullcontext()) as fallback:
                        params, opt_state, mets = step_fn(params, opt_state,
                                                          batch)
                except InjectedFailure as e:
                    print(f"[train] FAILURE: {e}")
                    if not args.ckpt_dir:
                        raise
                    if writer:
                        writer.wait()
                    last = ckpt.latest_step(args.ckpt_dir)
                    assert last is not None, "no checkpoint to restore"
                    # elastic restore onto the (possibly new) mesh
                    del params, opt_state
                    state = restore(last)
                    params, opt_state = state["params"], state["opt"]
                    pf.close()
                    step = last + 1
                    pf = Prefetcher(data_cfg, start_step=step)
                    print(f"[train] restored step {last}, resuming at {step}")
                    continue
                monitor.beat("worker0")
                if placed:
                    if not losses:
                        print(f"[train] ops resharded in the first step: "
                              f"{dict(fallback.reshards)}", flush=True)
                    reshards.update(fallback.reshards)
                loss = float(mets["loss"])
                losses.append(loss)
                step_ms.append((time.perf_counter() - t_step) * 1e3)
                if step % 5 == 0 or step == args.steps - 1:
                    dt = time.perf_counter() - t_start
                    print(f"[train] step {step:4d} loss {loss:7.4f} "
                          f"gnorm {float(mets.get('grad_norm', 0)):6.3f} "
                          f"({dt:5.1f}s)", flush=True)
                if writer and step % args.ckpt_every == 0:
                    writer.save_async(step, {"params": params,
                                             "opt": opt_state})
                step += 1
        finally:
            pf.close()
            if writer:
                writer.wait()
    print(f"[train] done: first loss {losses[0]:.4f} "
          f"last loss {losses[-1]:.4f}; step ms "
          f"{[round(t, 1) for t in step_ms]}")
    return {"losses": losses, "step_ms": step_ms, "mesh": mesh,
            "rules": rules, "pshard": pshard, "placed": placed,
            "reshards": dict(reshards), "params": params,
            "opt_state": opt_state, "step_fn": step_fn}


if __name__ == "__main__":
    main()
