"""Multi-tenant serving driver: HydraCluster/HydraPlatform/HydraRuntime +
continuous batching.

**Closed-loop LM serving**: registers N tenant functions (optionally
different architectures, each at its ``reduced()`` size) and replays a
synthetic request stream through continuous batchers, reporting density
metrics: placement, pool behaviour, program-cache sharing, tokens per
second.

The serving stack is selected by flags, as in ``repro.launch.serve``:

  * ``--nodes K`` (K >= 2) — a ``HydraCluster`` of K logical nodes:
    colocation-aware cross-node placement, snapshot migration, and
    EWMA-adaptive per-node pre-warmed pools.
  * ``--pool N`` (default 2, with ``--nodes`` < 2) — one ``HydraPlatform``:
    a pre-warmed pool of N generic runtimes with colocation-aware
    placement and snapshot/restore.
  * ``--pool 0`` — a single raw ``HydraRuntime``.

``--runtime-budget-gb`` caps each runtime's memory budget,
``--node-memory-gb`` each cluster node's placement budget, and
``--snapshot-dir`` enables sandbox snapshot/evict/restore (and is required
for cluster migration). It runs on CUDA unless ``--device cpu`` is given;
every runtime of the stack runs on that one device. The open-loop gateway
(``--gateway``) is not ported yet and exits with an error.

  PYTHONPATH=src python -m repro_torch.launch.serve --tenants 2 --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --nodes 2 --pool 1

This module is a package (``serve/__init__.py``) rather than
``serve.py`` so that the documentation's bare ``launch/serve.py``
references keep resolving to one file; the module path
``repro_torch.launch.serve`` mirrors ``repro.launch.serve``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (ClusterParams, ContinuousBatcher, HydraCluster,
                              HydraPlatform, HydraRuntime, LMSpec,
                              PlatformParams)
from repro_torch.device import resolve_device
from repro_torch.models.programs import ModelProgram


def make_params(cfg, seed: int = 0, device=None):
    """The port's own seeded init, cast to bf16 for serving."""
    return ModelProgram(cfg).init(seed, device=device, dtype=torch.bfloat16)


def build_target(args, device):
    """The serving stack selected by --nodes/--pool, every runtime of it
    on ``device``."""
    budget = int(args.runtime_budget_gb * (1 << 30))
    if args.nodes >= 2:
        return HydraCluster(ClusterParams(
            n_nodes=args.nodes,
            node_memory_bytes=int(args.node_memory_gb * (1 << 30)),
            snapshot_dir=args.snapshot_dir,
            platform=PlatformParams(pool_size=max(args.pool, 1),
                                    runtime_budget_bytes=budget,
                                    device=device)))
    if args.pool > 0:
        return HydraPlatform(PlatformParams(
            pool_size=args.pool, runtime_budget_bytes=budget,
            snapshot_dir=args.snapshot_dir, device=device))
    return HydraRuntime(device=device, memory_budget_bytes=budget)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="qwen2.5-3b",
                    help="comma-separated model architectures to serve "
                         "(the dense, ssm and hybrid families are ported, "
                         "e.g. qwen2.5-3b,mamba2-780m,zamba2-2.7b)")
    ap.add_argument("--tenants", type=int, default=2,
                    help="tenants per architecture (each gets its own "
                         "registered function)")
    ap.add_argument("--requests", type=int, default=16,
                    help="closed-loop requests to issue in total")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous-batching slots per LM function")
    ap.add_argument("--max-seq", type=int, default=128,
                    help="KV-cache sequence capacity per slot")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="synthetic prompt length in tokens")
    ap.add_argument("--max-new", type=int, default=16,
                    help="tokens to generate per request")
    ap.add_argument("--pool", type=int, default=2,
                    help="pre-warmed platform pool size (0 = raw runtime)")
    ap.add_argument("--nodes", type=int, default=0,
                    help="serve through a HydraCluster of this many "
                         "logical nodes (< 2 = single-node "
                         "platform/runtime)")
    ap.add_argument("--gateway", action="store_true",
                    help="open-loop trace replay; not ported yet")
    ap.add_argument("--runtime-budget-gb", type=float, default=8.0,
                    help="per-runtime memory budget in GiB (registration "
                         "admission + arena capacity)")
    ap.add_argument("--node-memory-gb", type=float, default=16.0,
                    help="per-node placement budget (cluster mode)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="enable sandbox snapshot/restore under this dir")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the request stream")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to serve on")
    args = ap.parse_args(argv)

    if args.gateway:
        ap.error("--gateway: not yet ported to repro_torch (use "
                 "repro.launch.serve); the closed-loop driver serves here")

    device = resolve_device(args.device)
    target = build_target(args, device)
    try:
        return _serve(args, target, device)
    finally:
        target.shutdown()


def _serve(args, target, device) -> dict:
    if isinstance(target, (HydraCluster, HydraPlatform)):
        platform = target
        # eager: place at registration so t_reg measures the real
        # install cost and no request pays a cold start
        register = lambda fid, spec, tenant: platform.register_function(
            fid, spec, tenant=tenant, eager=True)
        runtime_for = platform.runtime_for
        exe_cache = platform.exe_cache
    else:
        platform, rt = None, target
        register = rt.register_function
        runtime_for = lambda fid: rt
        exe_cache = rt.exe_cache
    archs = args.archs.split(",")
    rng = np.random.default_rng(args.seed)

    # one set of weights per tenant; every tenant of an arch shares the
    # same programs (code-cache sharing) but registers its own function
    t0 = time.perf_counter()
    fids = []
    for t in range(args.tenants):
        arch = archs[t % len(archs)]
        cfg = get_config(arch).reduced()
        spec = LMSpec(cfg=cfg, params=make_params(cfg, seed=args.seed + t,
                                                  device=device),
                      max_seq=args.max_seq, slots=args.slots)
        fid = f"tenant{t}/{arch}"
        register(fid, spec, tenant=f"tenant{t}")
        fids.append(fid)
    t_reg = time.perf_counter() - t0

    batchers = {fid: ContinuousBatcher(runtime_for(fid), fid)
                for fid in fids}
    print(f"[serve] registered {len(fids)} functions in {t_reg:.1f}s on "
          f"{device} (exe cache: {exe_cache.stats()})")

    futs = []
    t0 = time.perf_counter()
    try:
        for _ in range(args.requests):
            fid = fids[int(rng.integers(len(fids)))]
            prompt = rng.integers(2, 100, args.prompt_len).tolist()
            if isinstance(platform, HydraCluster):
                # batchers talk to runtimes directly; tell the cluster
                # about the arrival so adaptive pool sizing sees the load
                platform.observe_arrival(fid)
            futs.append(batchers[fid].submit(prompt, args.max_new))
            # interleave stepping: every submit, run one tick on all
            for b in batchers.values():
                if b.active or b.pending:
                    b.step()
        for b in batchers.values():
            b.run_until_done()
        toks = sum(len(f.result()) for f in futs)
        dt = time.perf_counter() - t0
    finally:
        for b in batchers.values():
            b.close()

    print(f"[serve] {args.requests} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s)")
    s = target.stats()
    if isinstance(platform, HydraCluster):
        for i, ns in enumerate(s["nodes"]):
            print(f"[serve] node{i}: {ns['runtimes_active']} active, "
                  f"{ns['runtimes_pooled']} pooled (target "
                  f"{ns['pool_target']}), committed "
                  f"{ns['committed_bytes'] / 2**20:.1f} MB")
        print(f"[serve] cluster placement: {platform.placement()}")
        print(f"[serve] cluster metrics: {s['metrics']['counters']}")
    elif platform is not None:
        print(f"[serve] platform: {s['runtimes_active']} active runtimes, "
              f"{s['runtimes_pooled']} pooled, placement "
              f"{platform.placement()}")
        print(f"[serve] platform metrics: {s['metrics']['counters']}")
        print(f"[serve] budget used {s['budget_used'] / 2**20:.0f} MB")
    else:
        print(f"[serve] arena stats: {rt.arena_pool.stats()}")
        print(f"[serve] budget used {s['budget_used'] / 2**20:.0f} MB "
              f"(peak {s['budget_peak'] / 2**20:.0f} MB)")
    print(f"[serve] exe cache: {exe_cache.stats()}")
    return {**s, "requests": args.requests, "tokens": toks, "wall_s": dt}


if __name__ == "__main__":
    main()
