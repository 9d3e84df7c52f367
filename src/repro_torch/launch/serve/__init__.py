"""Multi-tenant serving driver: HydraRuntime + continuous batching.

**Closed-loop LM serving**: registers N tenant functions (optionally
different architectures, each at its ``reduced()`` size) in one raw
``HydraRuntime`` and replays a synthetic request stream through
continuous batchers, reporting density metrics: arena-pool behaviour,
program-cache sharing, tokens per second.

It runs on CUDA unless ``--device cpu`` is given. The platform pool
(``--pool > 0``), the cluster (``--nodes``) and the open-loop gateway
(``--gateway``) are not ported yet and exit with an error.

  PYTHONPATH=src python -m repro_torch.launch.serve --tenants 2 --requests 8

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
from repro_torch.core import ContinuousBatcher, HydraRuntime, LMSpec
from repro_torch.models.programs import ModelProgram


def make_params(cfg, seed: int = 0, device=None):
    """The port's own seeded init, cast to bf16 for serving."""
    return ModelProgram(cfg).init(seed, device=device, dtype=torch.bfloat16)


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
    ap.add_argument("--pool", type=int, default=0,
                    help="pre-warmed platform pool size; only 0 (a raw "
                         "runtime) is ported so far")
    ap.add_argument("--nodes", type=int, default=0,
                    help="cluster nodes; not ported yet (must be < 2)")
    ap.add_argument("--gateway", action="store_true",
                    help="open-loop trace replay; not ported yet")
    ap.add_argument("--runtime-budget-gb", type=float, default=8.0,
                    help="runtime memory budget in GiB (registration "
                         "admission + arena capacity)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the request stream")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to serve on")
    args = ap.parse_args(argv)

    missing = [flag for flag, on in (("--pool > 0", args.pool > 0),
                                     ("--nodes >= 2", args.nodes >= 2),
                                     ("--gateway", args.gateway)) if on]
    if missing:
        ap.error(f"{', '.join(missing)}: not yet ported to repro_torch "
                 f"(use repro.launch.serve); only the raw runtime "
                 f"(--pool 0) serves here")

    rt = HydraRuntime(device=args.device,
                      memory_budget_bytes=int(args.runtime_budget_gb
                                              * (1 << 30)))
    try:
        return _serve(args, rt)
    finally:
        rt.shutdown()


def _serve(args, rt) -> dict:
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
                                                  device=rt.device),
                      max_seq=args.max_seq, slots=args.slots)
        fid = f"tenant{t}/{arch}"
        rt.register_function(fid, spec, tenant=f"tenant{t}")
        fids.append(fid)
    t_reg = time.perf_counter() - t0

    batchers = {fid: ContinuousBatcher(rt, fid) for fid in fids}
    print(f"[serve] registered {len(fids)} functions in {t_reg:.1f}s on "
          f"{rt.device} (exe cache: {rt.exe_cache.stats()})")

    futs = []
    t0 = time.perf_counter()
    try:
        for _ in range(args.requests):
            fid = fids[int(rng.integers(len(fids)))]
            prompt = rng.integers(2, 100, args.prompt_len).tolist()
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
    s = rt.stats()
    print(f"[serve] arena stats: {rt.arena_pool.stats()}")
    print(f"[serve] exe cache: {rt.exe_cache.stats()}")
    print(f"[serve] budget used {s['budget_used'] / 2**20:.0f} MB "
          f"(peak {s['budget_peak'] / 2**20:.0f} MB)")
    return {**s, "requests": args.requests, "tokens": toks, "wall_s": dt}


if __name__ == "__main__":
    main()
