#!/usr/bin/env python3
"""On-card smoke test of repro_torch, the PyTorch/CUDA port of Hydra.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc/`` (one nvcc per source, all started together) and then runs eight
phases (the serving paths of phases 2-4 now include five more
architectures, 4a-4e, and phase 5a trains); any failure exits non-zero.

1. Each kernel against its plain PyTorch version on the card, in bf16 and
   fp32, at the full-width shapes of the serving paths plus edge cases,
   with the tolerances of tests/test_kernels.py (fp32 2e-5, bf16 5e-2,
   the SSD final state 1e-3): rmsnorm at the three paths' widths, odd
   widths and unaligned rows; flash and decode attention at
   qwen2.5-3b's, zamba2-2.7b's (head dim 80) and gemma3-1b's (head dim
   256, 4 q / 1 KV head, window 512) shapes, ragged S, a window, deep
   GQA, decode lengths 0, 1 and > S, lengths that end inside a split and
   windows that leave most splits empty; the new families' shapes
   (granite-moe-1b-a400m hd 64 group 2, musicgen-large hd 64 group 1,
   dbrx-132b hd 128 group 6, internvl2-76b hd 128 group 8) with timed
   rows, and rmsnorm rows of d 1024, 1152, 6144 and 8192 (the last two
   wider than the register buckets: the scalar variant); ssd_scan at zamba2's
   and mamba2's 500-token prefill (chunk 256), the tests' sweep (ragged
   S, an init state, chunk 8), S < 8, B = 2, P 8 and 128, N 20, four
   chunks, the 128-token prompt and the served column-slice layout, each
   call twice (bit-equal). It times each kernel, its plain version and,
   where one exists, one PyTorch library call for the same function
   (never called by the port) as a yardstick: CUDA events over
   back-to-back calls, and the device time of one call from
   torch.profiler (``device_ms``: kernel durations summed, without the
   host's launch gaps, which events over back-to-back calls of a
   few-microsecond kernel measure instead); rmsnorm also at the zamba2
   and mamba2 decode rows and a 500-token prompt, with its events time
   per call beside ``F.rms_norm``'s over 3 repetitions. Each row records
   its CTA count (decode: the split plan; ssd_scan: each pass) and the
   kernels' registers and spills from the ptxas report. The backward
   kernels (training) against autograd of their plain versions, each call
   twice and bit-equal: ``rmsnorm_bwd`` at 8 x 128 rows of d 2048, 1024,
   1152, 6144, 8192 and 2047 (bf16 x, fp32 master w; dw relative to its
   largest |dw|) and fp32 x; ``flash_attention_bwd`` (dq, dk, dv) at
   qwen's training shape (8,128,16,128) / KV 2, a 500-token prompt,
   granite-moe's hd 64 group 2, gemma3's hd 256 window 512 (S 1024), a
   ragged S and fp32; each timed backward only (autograd over a kept
   graph for the plain version and the library call: ``F.rms_norm``'s
   backward, SDPA's with ``enable_gqa``) beside its bound.
2. qwen2.5-3b (dense) at full width: the port's seeded init (36 layers,
   bf16) registered in a ``HydraRuntime`` (slots 4, max_seq 1024), one
   ``generate`` per prompt (128 and 500 tokens), then six requests
   through one ``ContinuousBatcher``. Batched tokens must equal the
   single-path tokens, every kernel of the path must be launched, and the
   prefill and first decode logits must match the plain path on the card.
3. zamba2-2.7b (hybrid: 54 Mamba2 layers, one shared attention block
   applied 9 times) at full width, the same way; it runs all four kernels,
   ssd_scan 54 times per prefill. A profile of one 500-token prefill
   (device time by class, the device's busy share) and a decode-step
   profile follow.
4. mamba2-780m (ssm) at full width: a 500-token prefill profile, both
   prompts, then four batched requests whose tokens must equal the
   single-path tokens.
4a. granite-moe-1b-a400m (moe: 24 layers, 32 experts, top-8) as phase 2,
   its logits held as zamba2's (a near-tie in routing can flip between
   the kernel and the plain path), with a decode-step profile and, over
   the 128-token prompt, the choices dropped at capacity per layer and
   the routing decisions that differ between the two paths.
4b. gemma3-1b (26 layers, hd 256, window 512 on 5 of 6 layers, tied
   262,144-row vocabulary) as phase 2.
4c. dbrx-132b at full width cut to 4 of its 40 layers (28.5 GB of bf16
   weights; 16 experts of 6144 x 10752, top-4) as phase 2, its logits
   held to the plain path by relative RMS alone (no fp32 copy fits).
4d. internvl2-76b (vlm) at full width cut to 8 of its 80 layers, through
   ``ModelProgram``: 4 rows of 256 prefix embeddings + 244 tokens, then
   32 decode steps at 4 slots, kernel path against plain path by
   relative RMS; then a tokens-only ``generate`` through ``HydraRuntime``.
4e. musicgen-large (audio, 48 layers) the same way on 4 rows of 128 frame
   embeddings and one frame per decode step; its ``LMSpec`` must be
   refused at ``register_function`` with the budget untouched.
5. The reduced closed-loop serve, ``repro_torch.launch.serve``, over one
   tenant each of qwen2.5-3b, mamba2-780m, zamba2-2.7b and
   granite-moe-1b-a400m.
5a. Training, from the launcher's pieces (``repro_torch.launch.train``:
   its flags, ``build``, ``make_batch``; fp32 masters, bf16 compute,
   batch 8, seq 128, AdamW with warmup_cosine, lr 1e-3 after 3 warmup
   steps): full-width qwen2.5-3b (36 layers) takes 8 steps of n_micro 1
   (the last under the profiler) and one of n_micro 2. Gates: every loss
   finite, the mean of the last 3 below the first, every step moves the
   parameters, 73 rmsnorm and 36 flash launches per step forward and
   backward, ``max_memory_allocated`` under the card's memory. Then the
   same model cut to 4 layers (the one cut): every parameter's gradient
   on the kernel path within 5e-2 relative RMS of the plain path's.
   gemma3-1b and granite-moe-1b-a400m at full width take 2 steps each
   (finite losses); the launcher's restart drill (reduced qwen2.5-3b, 18
   steps, a failure at 12, checkpoints every 5) must resume; and reduced
   mamba2-780m must be refused on the card (the ``ssd_scan`` backward's
   ``NotImplementedError``) with its parameters unchanged.
6. The platform at full width: two tenants' qwen2.5-3b functions in a
   ``HydraPlatform`` (pool 2, 16 GiB per runtime) pack into one runtime
   with the program count of one; one is generated from (a 128-token
   prompt, 32 new tokens), snapshotted, evicted and restored, and must
   give the same tokens with no new program, bit-equal weights
   (checksums), and ``torch.cuda.memory_allocated()`` falling by at
   least 90% of the weights' bytes at eviction and rising again at
   restore. Then it is exported, and a fresh process on the same card
   (this script, ``--restore-child``) imports it and restores it from
   the snapshot with 0 compiles, at least one disk hit, no kernel library
   rebuilt and the same tokens. Snapshots live under a temporary
   directory that is removed at the end.
7. The cluster at full width: ``HydraCluster`` with two logical nodes on
   the card and an 8 GiB node budget, so qwen2.5-3b and mamba2-780m of
   one tenant cannot share a node and the second spills to node 1;
   mamba2-780m then migrates to node 0 through its snapshot, with the
   same tokens, no new program, and ``transfer_bytes`` equal to the
   snapshot's size; both functions serve after it.
8. The live serving gateway, replaying ``benchmarks/data/azure_sample.csv``
   (36 functions, 18 owners, 5,262 invocations over 30 trace minutes)
   open-loop on the card, in three legs:
   (a) ``run_validation`` at the reference settings (compress 60, pool 4,
       mem_scale 1/64, round trip, attribution): the cold-start, p99 and
       round-trip gates must pass; then the first 3 trace minutes replay
       with every request traced, the spans are exported as Chrome JSON
       and ``python -m repro_torch.core.tracing --check`` must accept it;
   (b) the same validation at full size (mem_scale 1.0, compress 120):
       every arena is the trace's own allocated size on the card and the
       runtime budget is the simulator's 2 GiB ``runtime_cap``; the gates,
       zero invoke errors, and the growth of
       ``torch.cuda.max_memory_allocated`` over the replay above 0 and at
       most the runtimes booted times 2 GiB;
   (c) ``python -m repro_torch.launch.serve --gateway --nodes 2`` as a
       child process at compress 120 with ``--calibration``: every
       request served or dropped, no errors, a calibration that
       ``repro_torch.core.calibrate`` loads, and the balancer's stats.
   In every leg (and the traced replay) the replay's warm-up must have
   reached every executable cache on the card, and the compiles on the
   clock, each cache's count less its count when the clock started
   (leg c reads them from its calibration's meta), must be 0.
   Each leg reports requests, drops, cold starts, pool claims, p50/p99
   (trace s and wall ms), per-request overhead, the traced per-phase
   p50/p99, live-vs-sim deltas, compiles after the warm-up, and the
   calibration's boot/register/claim/restore costs. The gateway's
   emulated function is one affine program, so the four kernels'
   counters over the phase are reported and expected to be 0 (not a
   gate).

Each serving path sets the launch counters to 0 just before its runtime
run and reads them just after; the platform, cluster and gateway phases
count theirs under the paths ``platform``, ``cluster`` and ``gateway``,
and the training runs under ``train qwen``, ``train gemma3-1b``, ``train
granite-moe-1b-a400m`` and ``train drill``.

Output: the card's name and power limit first; a ``{"kernels": [...]}``
line before the last; and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU, or outside a checkout, it exits non-zero with no result.
A full report (with the compiler's register/spill report) goes to
``chiprun_out/chip_smoke_report.json``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM data-sheet peaks (dense): HBM bandwidth, bf16 tensor-core rate,
# fp32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}   # tests/test_kernels.py
QWEN = dict(Hq=16, Hkv=2, hd=128, D=2048)
ZAMBA = dict(Hq=32, Hkv=32, hd=80, G=9, H=80, P=64, N=64,   # G: shared
             D=2560)                                         # block uses
MAMBA = dict(H=48, P=64, N=128, D=1536)
GEMMA3 = (4, 1, 256)             # gemma3-1b: q heads, KV heads, head dim
GEMMA3_WINDOW = 512              # its local layers' sliding window
# the new families' attention: q heads, KV heads, head dim, and the
# (batch, prompt) of their prefill and the layers of their full depth
GRANITE_MOE = (16, 8, 64)        # group 2
MUSICGEN = (32, 32, 64)          # group 1
DBRX = (48, 8, 128)              # group 6: decode's G=8 instantiation
INTERNVL = (64, 8, 128)          # group 8
SSD_CHUNK = 256
REPORT = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: the summed durations of the
    kernels (and copies) it runs on the card, from torch.profiler, over
    ``iters`` calls after a warm-up. Unlike cuda_ms it leaves out the gaps
    while the host enqueues the next launch, which dominate a call whose
    kernels take microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):              # a window the profiler saw no kernel in
        with profile(activities=[ProfilerActivity.CPU,  # is taken again
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if total:
            return total / 1e3 / iters
    return "not measured"


def device_ms_by_kernel(fn, keys: tuple, iters: int = 20) -> dict:
    """Device time of one call of ``fn`` split by kernel: for each of
    ``keys``, the summed durations of the kernels whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(keys, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = next((k for k in keys if k in e.name), None)
            if key:
                out[key] += e.time_range.elapsed_us() / 1e3 / iters
    return out


def compare(name: str, got, want, dtype, tol: float | None = None) -> float:
    """max |got - want|; fails unless |got - want| <= tol + tol*|want|
    (tol defaults to the dtype's tolerance)."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    tol = TOL[dtype] if tol is None else tol
    bad = err > tol + tol * w.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond "
                             f"tol {tol} (max abs err {max_err:.3e})")
    log(f"[kernels] {name}: max_abs_err {max_err:.3e} (tol {tol})")
    return max_err


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def bound(nbytes: int, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------
def phase_kernels() -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models.attention import GLOBAL_WINDOW

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}

    # ---- rmsnorm: decode rows (4 slots), a 500-token prompt, small rows
    for shape in [(4, 1, QWEN["D"]), (1, 500, QWEN["D"]), (3, 17, 64),
                  (4, 1, ZAMBA["D"]), (4, 1, MAMBA["D"]), (5, 100),
                  (13, 2048), (4, 1, 1024), (4, 1, 1152), (4, 1, 6144),
                  (4, 1, 8192), (4, 500, 8192)]:
        for xd, wd in [(f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16)]:
            x = randn(shape, xd, gen)
            w = (randn(shape[-1:], f32, gen) * 0.1).to(wd)
            compare(f"rmsnorm {shape} x={xd} w={wd}", rmsnorm(x, w),
                    ref.rmsnorm_ref(x, w), xd)
    # rows whose data pointer is 2 bytes off 16: the kernel's scalar variant
    x = randn((4 * QWEN["D"] + 1,), bf16, gen)[1:].view(4, 1, QWEN["D"])
    w = (randn((QWEN["D"],), f32, gen) * 0.1).to(bf16)
    compare("rmsnorm unaligned rows", rmsnorm(x, w), ref.rmsnorm_ref(x, w),
            bf16)
    out["rmsnorm"] = time_rmsnorm(gen)

    # ---- flash attention: the main path's prefill shape, plus the sweep
    H, K, hd = QWEN["Hq"], QWEN["Hkv"], QWEN["hd"]
    cases = [(1, 500, H, K, hd, True, None), (1, 128, H, K, hd, True, None),
             (1, 500, H, K, hd, True, 64),
             (2, 128, 4, 2, 64, True, None), (1, 256, 4, 1, 32, True, 64),
             (2, 100, 8, 8, 16, True, None), (1, 64, 4, 4, 128, False, None),
             (1, 64, 16, 2, 8, True, 16), (2, 333, 8, 2, 128, True, None),
             (1, 640, *GEMMA3, True, GEMMA3_WINDOW),
             (2, 200, *GEMMA3, True, None),
             (1, 500, *GRANITE_MOE, True, None), (4, 128, *MUSICGEN, True,
                                                  None),
             (1, 500, *DBRX, True, None), (2, 500, *INTERNVL, True, None)]
    for dt in (f32, bf16):
        for B, S, hq, hkv, d, causal, win in cases:
            q = randn((B, S, hq, d), dt, gen)
            k = randn((B, S, hkv, d), dt, gen)
            v = randn((B, S, hkv, d), dt, gen)
            got = flash_attention(q, k, v, causal=causal, window=win)
            compare(f"flash {B},{S},{hq},{hkv},{d} causal={causal} "
                    f"win={win} {dt}", got,
                    ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=win), dt)
            if win is None:
                same = flash_attention(q, k, v, causal=causal,
                                       window=GLOBAL_WINDOW)
                if not torch.equal(same, got):
                    raise AssertionError("flash: GLOBAL_WINDOW != None")
    S = 500
    out["flash_attention"] = time_flash(
        *(randn((1, S, h, hd), bf16, gen) for h in (H, K, K)),
        "flash main-path prefill")

    # ---- decode attention: 4 slots over a 1024-row cache, plus edges
    dcases = [(4, 1024, H, K, hd, None, [0, 1, 700, 1500]),
              (4, 1024, H, K, hd, 256, [0, 1, 700, 1500]),
              (4, 1024, H, K, hd, 256, [1100, 1300, 5, 1024]),
              (2, 256, 4, 2, 64, None, None), (3, 100, 8, 1, 32, None, None),
              (2, 512, 4, 4, 128, 128, None), (1, 64, 16, 2, 16, None, None),
              (3, 1024, H, K, hd, None, [45, 77, 1000]),   # ends mid-split
              (2, 1024, H, K, hd, 20, [1000, 33]),    # most splits empty
              (4, 1024, *GEMMA3, GEMMA3_WINDOW, [700, 1024, 0, 1500]),
              (2, 1024, *GEMMA3, None, [144, 516]),
              (4, 1024, *GRANITE_MOE, None, [0, 1, 700, 1500]),
              (4, 1024, *MUSICGEN, None, [160, 33, 1024, 1]),
              (4, 1024, *DBRX, None, [0, 1, 700, 1500]),
              (4, 1024, *DBRX, None, [532, 45, 1000, 77]),
              (4, 1024, *INTERNVL, None, [532, 1, 1024, 700])]
    for dt in (f32, bf16):
        for B, S, hq, hkv, d, win, lens in dcases:
            q = randn((B, hq, d), dt, gen)
            kc = randn((B, S, hkv, d), dt, gen)
            vc = randn((B, S, hkv, d), dt, gen)
            if lens is None:
                lengths = torch.randint(1, S + 1, (B,), generator=gen,
                                        device="cuda", dtype=torch.int32)
            else:
                lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = decode_attention(q, kc, vc, lengths, window=win)
            compare(f"decode {B},{S},{hq},{hkv},{d} win={win} "
                    f"lens={lengths.tolist()} {dt}", got,
                    ref.decode_attention_ref(q, kc, vc, lengths, window=win),
                    dt)
            if win is None:
                same = decode_attention(q, kc, vc, lengths,
                                        window=GLOBAL_WINDOW)
                if not torch.equal(same, got):
                    raise AssertionError("decode: GLOBAL_WINDOW != None")
    # main-path shape: the 36 layer slices of one slab
    B, S = 4, 1024
    out["decode_attention"] = time_decode(
        randn((B, H, hd), bf16, gen),
        *(randn((36, B, S, K, hd), bf16, gen) for _ in range(2)),
        "decode main-path step")

    out["flash_attention"]["hd80"] = attention_hd80(gen)
    out["decode_attention"]["hd80"] = decode_hd80(gen)
    # gemma3-1b's local layer: 4 q heads and 1 KV head of dim 256, window
    # 512, over a 1024-token prompt and a 1024-row cache (26 layer slices)
    hq, hkv, d = GEMMA3
    out["flash_attention"]["gemma3"] = time_flash(
        *(randn((1, 1024, h, d), bf16, gen) for h in (hq, hkv, hkv)),
        "flash gemma3 hd256 window 512", window=GEMMA3_WINDOW)
    out["decode_attention"]["gemma3"] = time_decode(
        randn((4, hq, d), bf16, gen),
        *(randn((26, 4, 1024, hkv, d), bf16, gen) for _ in range(2)),
        "decode gemma3 hd256 window 512 step", window=GEMMA3_WINDOW,
        lens=(700, 1024))
    # the new families' prefill and decode shapes: granite-moe-1b-a400m
    # (hd 64, group 2), musicgen-large (hd 64, group 1), dbrx-132b (hd
    # 128, group 6) and internvl2-76b (hd 128, group 8), each over a slab's
    # layer slices at full depth
    for label, (hq, hkv, d), (B, S), L in [
            ("granite-moe", GRANITE_MOE, (1, 500), 24),
            ("musicgen", MUSICGEN, (4, 128), 48),
            ("dbrx", DBRX, (1, 500), 40),
            ("internvl", INTERNVL, (4, 500), 80)]:
        out["flash_attention"][label] = time_flash(
            *(randn((B, S, h, d), bf16, gen) for h in (hq, hkv, hkv)),
            f"flash {label} hd{d} group {hq // hkv}")
        out["decode_attention"][label] = time_decode(
            randn((4, hq, d), bf16, gen),
            *(randn((L, 4, 1024, hkv, d), bf16, gen) for _ in range(2)),
            f"decode {label} hd{d} group {hq // hkv} step")
        torch.cuda.empty_cache()
    out["ssd_scan"] = phase_ssd(gen)
    out.update(phase_backward(gen))
    for name, r in out.items():
        for tag, t in [("", r)] + [(f" {k}", v) for k, v in r.items()
                                   if isinstance(v, dict) and "ms" in v]:
            lib_ms = ("none" if t["library_ms"] is None
                      else f"{t['library_ms']:.4f} ms")
            grid = (f"; device ms: kernel {t['device_ms']}, plain "
                    f"{t['plain_device_ms']}, library "
                    f"{t['library_device_ms']}; {t['ctas']} CTAs, ptxas "
                    f"{t['ptxas']}" if "ctas" in t else "")
            if "device_ms_by_pass" in t:
                grid += f"; device ms by pass {t['device_ms_by_pass']}"
            log(f"[kernels] {name}{tag} @ {t['shape']}: kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                f"{lib_ms}, bound {t['bound_ms']:.5f} ms ({t['bound_by']})"
                f"{grid}")
    return out


def ptxas_usage(stem: str, kernel: str, *parts: str) -> dict:
    """Registers and spills of one kernel instantiation from the ptxas -v
    report of ``csrc/<stem>.cu``: the first entry whose mangled name holds
    ``kernel`` and every one of ``parts`` (template arguments, e.g.
    "Li128E" for the int 128)."""
    from repro_torch.kernels import _build

    cur = None
    for line in _build.BUILD_LOGS.get(stem, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if kernel in name and all(p in name for p in parts) \
                else None
            spills = None
        elif cur and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                               r"loads", line).groups()
            spills = dict(spill_stores=int(st), spill_loads=int(ld))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            return dict(kernel=cur, registers=int(m.group(1)),
                        **(spills or {}))
    return {"kernel": kernel, "registers": "not measured"}


def timings(kern, plain, lib, iters: int) -> dict:
    """The kernel's, the plain version's and the library call's times
    (``lib`` None: no library call computes the function): CUDA events
    over back-to-back calls (``*ms``) and the device time of one call
    (``*device_ms``)."""
    return dict(ms=cuda_ms(kern, iters=iters),
                plain_ms=cuda_ms(plain, iters=iters),
                library_ms=cuda_ms(lib, iters=iters) if lib else None,
                device_ms=device_ms(kern), plain_device_ms=device_ms(plain),
                library_device_ms=device_ms(lib) if lib else None)


def time_rmsnorm(gen) -> dict:
    """rmsnorm (bf16 x and w) at the decode rows of the three serving
    paths and at a 500-token prompt: the kernel, its plain version and
    ``F.rms_norm`` (with w folded to 1 + w), events and device times;
    then the events time per call of the kernel and of ``F.rms_norm``
    over 3 repetitions, in turns. The first shape is the row's headline;
    the others nest under their labels."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm

    bf16 = torch.bfloat16
    rows = {}
    for label, shape in [("qwen decode", (4, 1, QWEN["D"])),
                         ("zamba2 decode", (4, 1, ZAMBA["D"])),
                         ("mamba2 decode", (4, 1, MAMBA["D"])),
                         ("qwen prefill", (1, 500, QWEN["D"])),
                         ("granite-moe decode", (4, 1, 1024)),
                         ("gemma3 decode", (4, 1, 1152)),
                         ("dbrx decode", (4, 1, 6144)),
                         ("internvl decode", (4, 1, 8192))]:
        D = shape[-1]
        x = randn(shape, bf16, gen)
        w = (randn((D,), torch.float32, gen) * 0.1).to(bf16)
        w1 = (1.0 + w.float()).to(bf16)
        err = compare(f"rmsnorm {label} {shape}", rmsnorm(x, w),
                      ref.rmsnorm_ref(x, w), bf16)
        kern = lambda: rmsnorm(x, w)
        lib = lambda: F.rms_norm(x, (D,), w1, 1e-5)
        t = timings(kern, lambda: ref.rmsnorm_ref(x, w), lib, iters=30)
        reps = [dict(kernel_ms=cuda_ms(kern, iters=300),
                     library_ms=cuda_ms(lib, iters=300)) for _ in range(3)]
        n = x.numel() // D
        b_ms, b_by = bound(2 * x.numel() * 2 + D * 2, 4.0 * x.numel(), bf16)
        # the register buckets hold rows of up to 32 lanes x 16 pieces of 8
        # bf16; a wider row takes the scalar variant
        nv = next((v for v in (2, 4, 8, 12, 16) if 32 * 8 * v >= D), None)
        variant = ("rmsnorm_kernel", "13__nv_bfloat16S1_", f"Li{nv}E") \
            if nv else ("rmsnorm_scalar_kernel", "13__nv_bfloat16S1_")
        rows[label] = dict(
            shape=list(shape), max_abs_err=err, ctas=-(-n // 8),
            warps=n, variant=variant[0],
            ptxas=ptxas_usage("rmsnorm", *variant),
            **t, events_per_call_3_reps=reps, bound_ms=b_ms, bound_by=b_by)
    head = rows.pop("qwen decode")
    head.update(rows)
    return head


def attention_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs a causal/windowed prefill of S tokens computes."""
    if not causal:
        return S * S
    w = window or S
    return sum(min(i + 1, w) for i in range(S))


def time_flash(q, k, v, name: str, window=None) -> dict:
    """Flash attention at a prefill shape (bf16, causal, ``window`` or
    none) against its plain version, then the kernel's, the plain
    version's and SDPA's times beside the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import GLOBAL_WINDOW

    B, S, H, hd = q.shape
    win = window or GLOBAL_WINDOW
    err = compare(name, flash_attention(q, k, v, window=win),
                  ref.flash_attention_ref(q, k, v, window=window),
                  torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    flops = 4.0 * hd * H * B * attention_pairs(S, True, window)  # QK^T, PV
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return dict(
        shape=list(q.shape), kv_heads=k.shape[2], window=window,
        max_abs_err=err, ctas=-(-S // 64) * H * B,
        ptxas=ptxas_usage("flash_attention", "flash_wgmma_kernel",
                          f"Li{hd}E"),
        **timings(lambda: flash_attention(q, k, v, window=win),
                  lambda: ref.flash_attention_ref(q, k, v, window=window),
                  lib, iters=30),
        bound_ms=b_ms, bound_by=b_by)


def time_decode(q, kc, vc, name: str, window=None,
                lens=(144, 516)) -> dict:
    """Decode attention at a decode shape: q (B,Hq,hd) bf16 against kc/vc
    (L,B,S,Hkv,hd), the layer slices of one slab, with ``lens`` repeated
    over the rows. Each timed launch takes the next slice, so it finds its
    cache cold in L2 as a decode step does."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      split_plan)
    from repro_torch.models.attention import GLOBAL_WINDOW

    L, B, S, K, hd = kc.shape
    H = q.shape[1]
    lengths = torch.tensor(list(lens) * (B // len(lens)), dtype=torch.int32,
                           device="cuda")
    win = window or GLOBAL_WINDOW
    err = compare(name, decode_attention(q, kc[0], vc[0], lengths,
                                         window=win),
                  ref.decode_attention_ref(q, kc[0], vc[0], lengths,
                                           window=window),
                  torch.bfloat16)
    it = iter(range(10 ** 9))
    layer = lambda: next(it) % L
    kt = kc.transpose(2, 3).contiguous()          # (L, B, Hkv, S, hd)
    vt = vc.transpose(2, 3).contiguous()
    pos = torch.arange(S, device="cuda")[None, :]
    ln = lengths[:, None].long()
    seen = (pos < ln) & (pos >= (ln - window if window else 0))
    mask = seen[:, None, None, :]
    visible = int(seen.sum())
    nbytes = (2 * visible * K * hd + 2 * q.numel()) * 2 + lengths.numel() * 4
    b_ms, b_by = bound(nbytes, 4.0 * hd * H * visible, torch.bfloat16)
    plan = split_plan(S, hd, q.dtype)
    G = next(g for g in (1, 2, 4, 8, 16) if g >= H // K)   # P V's template

    def lib():
        i = layer()
        return F.scaled_dot_product_attention(
            q[:, :, None], kt[i], vt[i], attn_mask=mask, enable_gqa=True)

    def kern():
        i = layer()
        return decode_attention(q, kc[i], vc[i], lengths, window=win)

    def plain():
        i = layer()
        return ref.decode_attention_ref(q, kc[i], vc[i], lengths,
                                        window=window)

    return dict(
        shape=[B, S, K, hd], q_heads=H, window=window,
        lengths=lengths.tolist(), max_abs_err=err, chunk=plan.chunk,
        splits=plan.splits, ctas=plan.splits * K * B,
        combine_ctas=H * B,
        ptxas=[ptxas_usage("decode_attention", "decode_scores_kernel",
                           "13__nv_bfloat16", f"Li{hd}EE"),
               ptxas_usage("decode_attention", "decode_pv_kernel",
                           "13__nv_bfloat16", f"Li{hd}ELi{G}E")],
        **timings(kern, plain, lib, iters=72), bound_ms=b_ms, bound_by=b_by)


def attention_hd80(gen) -> dict:
    """Flash attention at zamba2-2.7b's shared block: 32 q = 32 KV heads of
    dim 80, a 500-token prompt, causal, no window."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    H, hd, S = ZAMBA["Hq"], ZAMBA["hd"], 500
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (randn((1, S, H, hd), dt, gen) for _ in range(3))
        compare(f"flash zamba2 hd80 1,{S},{H},{H},{hd} {dt}",
                flash_attention(q, k, v), ref.flash_attention_ref(q, k, v),
                dt)
    return time_flash(q, k, v, "flash zamba2 hd80 main-path prefill")


def decode_hd80(gen) -> dict:
    """Decode attention at zamba2-2.7b's shared block: q (4,32,80) against
    the 9 block applications' (4,1024,32,80) caches of one slab."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention

    H, hd, G, B, S = ZAMBA["Hq"], ZAMBA["hd"], ZAMBA["G"], 4, 1024
    for dt in (torch.float32, torch.bfloat16):
        for lens in ([0, 1, 700, 1500], [1100, 1300, 5, 1024]):
            q = randn((B, H, hd), dt, gen)
            kc, vc = (randn((B, S, H, hd), dt, gen) for _ in range(2))
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            compare(f"decode zamba2 hd80 {B},{S},{H},{H},{hd} lens={lens} "
                    f"{dt}", decode_attention(q, kc, vc, lengths),
                    ref.decode_attention_ref(q, kc, vc, lengths), dt)
    return time_decode(
        randn((B, H, hd), torch.bfloat16, gen),
        *(randn((G, B, S, H, hd), torch.bfloat16, gen) for _ in range(2)),
        "decode zamba2 hd80 main-path step")


def ssd_inputs(gen, B, S, H, P, N, dtype, strided=False):
    """tests/test_kernels.py's distribution: softplus'd dt, A = -exp(0.3 z),
    B and C at half scale; x, B, C in ``dtype``, dt and A in fp32. With
    ``strided`` x, B and C are column slices of one (B, S, H*P + 2N)
    tensor, the layout of the serving path."""
    f32 = torch.float32
    if strided:
        xbc = randn((B, S, H * P + 2 * N), f32, gen)
        xbc[..., H * P:] *= 0.5
        xbc = xbc.to(dtype)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    else:
        x = randn((B, S, H, P), dtype, gen)
        Bm, Cm = ((randn((B, S, N), f32, gen) * 0.5).to(dtype)
                  for _ in range(2))
    dt = torch.nn.functional.softplus(randn((B, S, H), f32, gen))
    A = -torch.exp(randn((H,), f32, gen) * 0.3)
    return x, dt, A, Bm, Cm


def ssd_bound(B, S, H, P, N, chunk, dtype) -> tuple:
    """Least time for one scan with its final state: x, dt, A, B, C read
    once, y and the fp32 state written once; the chunked products with
    C B^T counted once per chunk (it does not depend on the head), on the
    rows this S really has."""
    xb = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * S * H * P * xb + B * S * H * 4 + H * 4
              + 2 * B * S * N * xb + B * H * P * N * 4)
    rows = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    pairs = sum(r * (r + 1) // 2 for r in rows)
    flops = 2.0 * B * pairs * N + 2.0 * B * H * pairs * P \
        + 4.0 * B * H * S * N * P
    return bound(nbytes, flops, dtype)


def phase_ssd(gen) -> dict:
    """ssd_scan against ssd_scan_ref: y at the dtype's tolerance, the fp32
    final state at 1e-3 (tests/test_kernels.py)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import scan_plan, ssd_scan

    cases = [  # B, S, H, P, N, chunk, init, strided, what
        (1, 500, ZAMBA["H"], ZAMBA["P"], ZAMBA["N"], SSD_CHUNK, False, False,
         "zamba2 prefill"),
        (1, 500, MAMBA["H"], MAMBA["P"], MAMBA["N"], SSD_CHUNK, False, False,
         "mamba2 prefill"),
        (2, 64, 4, 16, 16, 16, False, False, "sweep"),
        (1, 100, 2, 32, 64, 32, True, False, "sweep ragged S + init"),
        (2, 33, 4, 64, 32, 8, False, False, "sweep chunk 8"),
        (1, 5, 8, 16, 16, 5, False, False, "S < 8"),
        (2, 300, 16, 64, 128, SSD_CHUNK, True, False, "B = 2 + init"),
        (1, 500, ZAMBA["H"], ZAMBA["P"], ZAMBA["N"], SSD_CHUNK, False, True,
         "zamba2 column slices"),
        (1, 128, ZAMBA["H"], ZAMBA["P"], ZAMBA["N"], 128, False, True,
         "128-token prompt"),
        (1, 257, 4, 64, 64, SSD_CHUNK, False, False, "S = 257"),
        (1, 1024, 4, 64, 64, SSD_CHUNK, False, False, "four chunks"),
        (2, 200, 4, 64, 128, SSD_CHUNK, True, False, "B = 2 + init N 128"),
        (1, 300, 4, 8, 64, SSD_CHUNK, False, False, "P = 8"),
        (1, 300, 4, 128, 128, SSD_CHUNK, True, False, "P = 128 + init"),
        (1, 77, 3, 32, 20, 64, False, False, "N = 20"),
    ]
    for dt in (torch.float32, torch.bfloat16):
        for B, S, H, P, N, chunk, init, strided, what in cases:
            args = ssd_inputs(gen, B, S, H, P, N, dt, strided)
            s0 = randn((B, H, P, N), torch.float32, gen) if init else None
            y, sf = ssd_scan(*args, chunk=chunk, init_state=s0,
                             return_state=True)
            yr, sr = ref.ssd_scan_ref(*args, chunk=chunk, init_state=s0,
                                      return_state=True)
            name = f"ssd_scan {what} {B},{S},{H},{P} N={N} chunk={chunk}"
            compare(f"{name} y {dt}", y, yr, dt)
            compare(f"{name} final state {dt}", sf, sr, torch.float32,
                    tol=1e-3)
            if not torch.equal(ssd_scan(*args, chunk=chunk, init_state=s0),
                               y):
                raise AssertionError(f"{name} {dt}: two calls differ")

    def timed(H, P, N) -> dict:
        B, S = 1, 500
        args = ssd_inputs(gen, B, S, H, P, N, torch.bfloat16, strided=True)
        kern = lambda: ssd_scan(*args, chunk=SSD_CHUNK, return_state=True)
        plain = lambda: ref.ssd_scan_ref(*args, chunk=SSD_CHUNK,
                                         return_state=True)
        err = compare(f"ssd_scan main-path prefill {B},{S},{H},{P} N={N}",
                      kern()[0], plain()[0], torch.bfloat16)
        b_ms, b_by = ssd_bound(B, S, H, P, N, SSD_CHUNK, torch.bfloat16)
        plan = scan_plan(S, SSD_CHUNK, P, N)
        return dict(shape=[B, S, H, P], N=N, chunk=SSD_CHUNK,
                    max_abs_err=err, ctas=plan.ctas(B, H, P, N),
                    ptxas=[ptxas_usage("ssd_scan", k, f"Li{P}E") for k in
                           ("ssd_chunk_kernel", "ssd_out_kernel")]
                    + [ptxas_usage("ssd_scan", "ssd_state_kernel")],
                    **timings(kern, plain, None, iters=30),
                    device_ms_by_pass=device_ms_by_kernel(
                        kern, KERNEL_CLASSES["ssd_scan"][1:]),
                    library="none: no PyTorch call computes SSD",
                    bound_ms=b_ms, bound_by=b_by)

    out = timed(ZAMBA["H"], ZAMBA["P"], ZAMBA["N"])
    out["mamba2"] = timed(MAMBA["H"], MAMBA["P"], MAMBA["N"])
    return out


# ---------------------------------------------------------------------------
# phase 1, the backward kernels: each against autograd of its plain version
# ---------------------------------------------------------------------------
TRAIN_B, TRAIN_S = 8, 128          # the launcher's batch and sequence


def twice_equal(name: str, fn) -> tuple:
    """``fn()`` run twice; the results must be bit-equal (no atomics)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two calls are not bit-equal")
    return a


def compare_dw(name: str, got, want, dtype) -> float:
    """A weight gradient summed over every row, compared relative to its
    largest |dw| (elementwise, a column whose terms cancel would be held
    to the fp32 tolerance of its own small sum); max abs error returned."""
    scale = float(want.float().abs().max()) or 1.0
    compare(name + " (/ max |dw|)", got.float() / scale,
            want.float() / scale, dtype)
    return float((got.float() - want.float()).abs().max())


def phase_backward(gen) -> dict:
    """Phase 1's backward rows: rmsnorm_bwd and flash_attention_bwd against
    autograd of their plain versions, each call twice and bit-equal, then
    timed at the training path's shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    # ---- rmsnorm: the training rows (8 x 128) at every width the model
    # families use, an odd width, and fp32 x; w is the fp32 master
    for D, xd in [(2048, bf16), (1024, bf16), (1152, bf16), (6144, bf16),
                  (8192, bf16), (2047, bf16), (2048, f32)]:
        shape = (TRAIN_B, TRAIN_S, D)
        x, dy = randn(shape, xd, gen), randn(shape, xd, gen)
        w = randn((D,), f32, gen) * 0.1
        dx, dw = twice_equal(f"rmsnorm_bwd {shape} {xd}",
                             lambda: rmsnorm_bwd(dy, x, w))
        rdx, rdw = ref.rmsnorm_bwd_ref(dy, x, w)
        compare(f"rmsnorm_bwd dx {shape} x={xd}", dx, rdx, xd)
        compare_dw(f"rmsnorm_bwd dw {shape} x={xd}", dw, rdw, f32)
    out["rmsnorm_bwd"] = time_rmsnorm_bwd(gen)

    # ---- flash attention: qwen's training shape, a 500-token prompt,
    # granite-moe's hd 64 group 2, gemma3's hd 256 window 512, ragged S,
    # fp32
    H, K, hd = QWEN["Hq"], QWEN["Hkv"], QWEN["hd"]
    for B, S, hq, hkv, d, win, dt in [
            (TRAIN_B, TRAIN_S, H, K, hd, None, bf16),
            (1, 500, H, K, hd, None, bf16),
            (TRAIN_B, TRAIN_S, *GRANITE_MOE, None, bf16),
            (1, 1024, *GEMMA3, GEMMA3_WINDOW, bf16),
            (2, 333, 8, 2, 128, None, bf16),
            (2, TRAIN_S, H, K, hd, None, f32)]:
        q, dout = randn((B, S, hq, d), dt, gen), randn((B, S, hq, d), dt, gen)
        k, v = randn((B, S, hkv, d), dt, gen), randn((B, S, hkv, d), dt, gen)
        lse = torch.empty((B, hq, S), dtype=f32, device="cuda")
        o = _forward(q, k, v, True, win, None, lse)
        name = f"flash_bwd {B},{S},{hq},{hkv},{d} win={win} {dt}"
        got = twice_equal(name, lambda: flash_attention_bwd(
            q, k, v, o, lse, dout, window=win))
        want = ref.flash_attention_bwd_ref(q, k, v, dout, window=win)
        for nm, g, w in zip(("dq", "dk", "dv"), got, want):
            compare(f"{name} {nm}", g, w, dt)
    fa = time_flash_bwd(*(randn((TRAIN_B, TRAIN_S, h, hd), bf16, gen)
                          for h in (H, K, K, H)), "qwen training")
    fa["prompt500"] = time_flash_bwd(
        *(randn((1, 500, h, hd), bf16, gen) for h in (H, K, K, H)),
        "500-token prompt")
    hq, hkv, d = GRANITE_MOE
    fa["granite-moe"] = time_flash_bwd(
        *(randn((TRAIN_B, TRAIN_S, h, d), bf16, gen)
          for h in (hq, hkv, hkv, hq)), "granite-moe hd64 group 2")
    hq, hkv, d = GEMMA3
    fa["gemma3"] = time_flash_bwd(
        *(randn((1, 1024, h, d), bf16, gen) for h in (hq, hkv, hkv, hq)),
        "gemma3 hd256 window 512", window=GEMMA3_WINDOW)
    out["flash_attention_bwd"] = fa
    return out


def time_rmsnorm_bwd(gen) -> dict:
    """rmsnorm_bwd at the training path's rows (8 x 128 x 2048 bf16, fp32
    w): the kernel, autograd of the plain version and ``F.rms_norm``'s
    backward (w folded to 1 + w in bf16), backward only."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    bf16, f32 = torch.bfloat16, torch.float32
    D = QWEN["D"]
    shape = (TRAIN_B, TRAIN_S, D)
    x, dy = randn(shape, bf16, gen), randn(shape, bf16, gen)
    w = randn((D,), f32, gen) * 0.1
    dx, dw = rmsnorm_bwd(dy, x, w)
    rdx, rdw = ref.rmsnorm_bwd_ref(dy, x, w)
    err = max(compare("rmsnorm_bwd main-path dx", dx, rdx, bf16),
              compare_dw("rmsnorm_bwd main-path dw", dw, rdw, f32))
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    yp = ref.rmsnorm_ref(xp, wp)
    xl = x.clone().requires_grad_()
    wl = (1.0 + w).to(bf16).requires_grad_()
    yl = F.rms_norm(xl, (D,), wl, 1e-5)
    # backward only: autograd over a kept graph for the plain version and
    # the library call
    t = timings(
        lambda: rmsnorm_bwd(dy, x, w),
        lambda: torch.autograd.grad(yp, (xp, wp), dy, retain_graph=True),
        lambda: torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True),
        iters=20)
    n = x.numel()
    # dy and x read, dx written (bf16); w read and dw written (fp32);
    # about 12 fp32 flops per element on the CUDA cores
    b_ms, b_by = bound(3 * n * 2 + 2 * D * 4, 12.0 * n, f32)
    rows = n // D
    return dict(shape=list(shape), w_dtype="float32", max_abs_err=err,
                ctas=dict(dx=-(-rows // 8), dw_partial=[-(-D // 256),
                                                        "chunks by shape"],
                          dw_final=-(-D // 256)),
                ptxas=ptxas_usage("rmsnorm_bwd", "rmsnorm_bwd_kernel",
                                  "13__nv_bfloat16fLb1E"),
                device_ms_by_pass=device_ms_by_kernel(
                    lambda: rmsnorm_bwd(dy, x, w),
                    ("rmsnorm_bwd_kernel", "rmsnorm_dw_partial",
                     "rmsnorm_dw_final")),
                **t, bound_ms=b_ms, bound_by=b_by)


def time_flash_bwd(q, k, v, dout, name: str, window=None) -> dict:
    """flash_attention_bwd at a training shape (bf16, causal, ``window`` or
    none) against autograd of the plain version, then the kernel's, the
    plain version's and SDPA's backward times (backward only, over a kept
    graph) beside the bound: max(bytes once / 3.35 TB/s, 2.5 x the
    forward's visible-pair flops / 989 TFLOP/s)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention_bwd)

    B, S, H, hd = q.shape
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    o = _forward(q, k, v, True, window, None, lse)
    kern = lambda: flash_attention_bwd(q, k, v, o, lse, dout, window=window)
    got, want = kern(), ref.flash_attention_bwd_ref(q, k, v, dout,
                                                    window=window)
    err = max(compare(f"flash_bwd {name} {nm}", g, w, torch.bfloat16)
              for nm, g, w in zip(("dq", "dk", "dv"), got, want))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    op = ref.flash_attention_ref(*ins, window=window)
    lib_in = [t.transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
    if window is None:
        ol = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                            enable_gqa=True)
    else:
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        ol = F.scaled_dot_product_attention(*lib_in, attn_mask=mask,
                                            enable_gqa=True)
    dlib = dout.transpose(1, 2).contiguous()
    t = timings(
        kern, lambda: torch.autograd.grad(op, ins, dout, retain_graph=True),
        lambda: torch.autograd.grad(ol, lib_in, dlib, retain_graph=True),
        iters=20)
    # q, o, dO read and dq written; k, v read and dk, dv written (bf16);
    # lse read (fp32)
    nbytes = 4 * q.numel() * 2 + 4 * k.numel() * 2 + B * H * S * 4
    flops = 2.5 * 4.0 * hd * H * B * attention_pairs(S, True, window)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    hs = 2 if hd > 128 else 1
    return dict(
        shape=list(q.shape), kv_heads=k.shape[2], window=window,
        max_abs_err=err,
        ctas=dict(dq=-(-S // 64) * H * B, dkv=-(-S // 64) * H * B,
                  reduce=-(-B * S * k.shape[2] * hd // 256)),
        threads_per_cta=128 * hs,
        ptxas=dict(dq=ptxas_usage("flash_attention_bwd",
                                  "flash_bwd_dq_kernel", f"Li{hd}E"),
                   dkv=ptxas_usage("flash_attention_bwd",
                                   "flash_bwd_dkv_kernel", f"Li{hd}E")),
        device_ms_by_pass=device_ms_by_kernel(
            kern, ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                   "flash_bwd_reduce_kernel")),
        **t, bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------------------
# phases 2-4: the serving paths at full width
# ---------------------------------------------------------------------------
def grow_cache(cache: dict, rows: int) -> dict:
    """A copy of a prefill cache with ``rows`` zero rows appended to the
    K/V sequence axis (axis 2); SSM leaves have no sequence axis."""
    out = {}
    for k, v in cache.items():
        out[k] = (torch.cat([v, torch.zeros_like(v[:, :, :rows])], 2)
                  if k in ("k", "v") else v.clone())
    return out


def step_bytes(cfg, params, prog, slots: int, max_seq: int) -> tuple:
    """(weight bytes, SSM state bytes) one decode step must move. Every
    weight is read once, except the embedding table when it is not tied
    (the lookup gathers `slots` rows) and the hybrid's shared block, read
    once per application; an SSM state and conv window are read and
    written once per step."""
    from repro_torch.core.arena import tree_bytes
    from repro_torch.models.transformer import hybrid_groups

    weights = tree_bytes(params)
    if not cfg.tie_embeddings and "embed" in params:
        embed = params["embed"]["tok"]
        weights -= embed.numel() * embed.element_size()
    if cfg.family == "hybrid":
        weights += tree_bytes(params["shared"]) * (hybrid_groups(cfg) - 1)
    specs = prog.cache_specs(slots, max_seq)
    state = 2 * sum(specs[k].nbytes for k in ("conv", "state") if k in specs)
    return weights, state


class plain_path:
    """Every kernel's plain version while inside (REPRO_TORCH_KERNEL_MODE
    ref)."""
    def __enter__(self):
        from repro_torch.kernels import ops
        ops.set_kernel_mode("ref")

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.set_kernel_mode(None)


def first_logits(prog, params, prompt, cache_prog=None, cache_params=None):
    """(prefill logits, first decode logits) for ``prompt``: the kernel
    path and the plain path prefill alike; both decode the plain path's
    argmax token against the kernel path's cache (grown by 32 rows)."""
    with torch.no_grad():
        toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
        pre_k, cache = prog.prefill(params, {"tokens": toks})
        with plain_path():
            pre_r, _ = prog.prefill(params, {"tokens": toks})
        nxt = torch.argmax(pre_r, -1).to(torch.int32)[:, None]
        cache_k = grow_cache(cache, 32)
        cache_r = {k: v.clone() for k, v in cache_k.items()}
        dec_k, _ = prog.decode_step(params, cache_k, {"tokens": nxt})
        with plain_path():
            dec_r, _ = prog.decode_step(params, cache_r, {"tokens": nxt})
    return (pre_k, pre_r), (dec_k, dec_r), nxt


def logits_direct(prog, params, prompt, arch) -> dict:
    """Kernel path against plain path, elementwise. Prefill runs many
    128-token bf16 attention layers whose softmax probabilities the kernel
    keeps in fp32 and the plain version rounds to bf16; the difference
    compounds through the residual stream, so that check takes twice the
    bf16 tolerance."""
    (pre_k, pre_r), (dec_k, dec_r), _ = first_logits(prog, params, prompt)
    return dict(
        prefill_logits_err=compare(
            f"{arch} prefill logits kernel vs plain", pre_k, pre_r,
            torch.bfloat16, tol=2 * TOL[torch.bfloat16]),
        decode_logits_err=compare(
            f"{arch} first decode logits kernel vs plain", dec_k, dec_r,
            torch.bfloat16))


def rel_rms(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_rel_rms(what: str, k, r) -> dict:
    """Kernel-path logits ``k`` within 5e-2 of the plain path's ``r`` in
    relative RMS (the bf16 tolerance); the elementwise max difference is
    reported."""
    d, max_abs = rel_rms(k, r), float((k.float() - r.float()).abs().max())
    log(f"[{what}] logits: kernel vs plain rel RMS {d:.3e} (max abs "
        f"{max_abs:.3e})")
    if not (torch.isfinite(k).all() and d <= TOL[torch.bfloat16]):
        raise AssertionError(f"{what} logits: kernel vs plain rel RMS "
                             f"{d:.3e} (limit 5e-2), or non-finite")
    return dict(rel_rms=d, max_abs=max_abs)


def logits_rms(prog, params, prompt, arch) -> dict:
    """Kernel path against plain path by relative RMS alone, for an moe
    model whose fp32 copy would not fit on the card beside it. The plain
    path replays the kernel path's experts (see logits_fp32 for why); the
    distances with each path's own routing are reported (``free``)."""
    (pre_k, pre_r), (dec_k, dec_r), nxt = first_logits(prog, params, prompt)
    free = dict(prefill=rel_rms(pre_k, pre_r), decode=rel_rms(dec_k, dec_r))
    log(f"[{arch}] logits rel RMS, kernel vs plain, each path's own routing "
        f"(not gated): {free}")
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        with routing_log() as routed:
            pre_k, dec_k = prompt_logits(prog, params, toks, nxt)
        with replay_experts(routed.calls), plain_path():
            pre_r, dec_r = prompt_logits(prog, params, toks, nxt)
    pre = check_rel_rms(f"{arch} prefill, same experts", pre_k, pre_r)
    dec = check_rel_rms(f"{arch} first decode, same experts", dec_k, dec_r)
    return dict(prefill_logits_err=pre["max_abs"],
                decode_logits_err=dec["max_abs"],
                prefill_logits_rel_rms=pre["rel_rms"],
                decode_logits_rel_rms=dec["rel_rms"], free=free)


class routing_log:
    """Every ``moe.route`` call while inside: (gate_idx, choice_slot,
    capacity) per layer, in call order."""
    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self._route = [], moe.route

        def route(p, xg, cfg, C):
            r = self._route(p, xg, cfg, C)
            self.calls.append((r.gate_idx, r.choice_slot, C))
            return r
        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route


class replay_experts:
    """Inside, the i-th ``moe.top_k`` call returns the experts of
    ``calls[i]`` (a routing_log of another run of the same inputs) with
    this run's probabilities: that run's routing, replayed."""
    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        from repro_torch.models import moe
        self._top_k, it = moe.top_k, iter(self.calls)

        def top_k(probs, K):
            idx = next(it)[0]
            return probs.gather(-1, idx), idx
        moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.top_k = self._top_k


def moe_routing(prog, params, prompt, arch) -> dict:
    """Over one prefill of ``prompt``: the choices dropped at capacity in
    each layer on the kernel path, and the routing decisions (a token's
    set of top-k experts) that differ between the kernel path and the
    plain path, per layer."""
    E = prog.cfg.moe.num_experts
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        with routing_log() as kern:
            prog.prefill(params, {"tokens": toks})
        with routing_log() as plain, plain_path():
            prog.prefill(params, {"tokens": toks})
    dropped, tokens_differ, choices_differ = [], [], []
    for (ik, sk, C), (ip, _, _) in zip(kern.calls, plain.calls):
        dropped.append(int((sk == E * C).sum()))
        ek, ep = ik.sort(-1).values, ip.sort(-1).values
        differ = (ek != ep)
        tokens_differ.append(int(differ.any(-1).sum()))
        # choices of the kernel path that the plain path did not make
        hit = (ek[..., :, None] == ep[..., None, :]).any(-1)
        choices_differ.append(int((~hit).sum()))
    C = kern.calls[0][2]
    res = dict(tokens=len(prompt), capacity=C,
               choices_per_layer=len(prompt) * prog.cfg.moe.top_k,
               dropped_per_layer=dropped,
               tokens_routed_differently_per_layer=tokens_differ,
               choices_differing_per_layer=choices_differ)
    log(f"[{arch}] {len(prompt)}-token prefill routing: capacity {C}; "
        f"choices dropped per layer {dropped} (of "
        f"{res['choices_per_layer']}); tokens whose experts differ, kernel "
        f"vs plain path, per layer {tokens_differ}; differing choices "
        f"{choices_differ}")
    return res


def logits_fp32(prog, params, prompt, arch) -> dict:
    """Kernel path against plain path for a deep bf16 model, where bf16
    rounding noise (one-ulp flips of the SSD output, fp32 vs bf16 softmax
    probabilities) compounds over 63 blocks and an elementwise check on
    logits measures that noise: the kernel path's logits must lie within
    5e-2 of the plain path's in relative RMS, and be at least as close as
    the plain path's (up to 1.25x) to an fp32 run of the same weights
    through the plain versions. The elementwise max difference is
    reported. For an moe model the two bf16 paths replay the fp32 run's
    experts (replay_experts): rounding flips a near-tie in routing on any
    path, and one flipped expert moves a token's logits more than every
    kernel's rounding together, so without the replay the check would
    measure which path flipped the same way as the fp32 run. Their
    distances with their own routing are reported beside (``free``)."""
    import dataclasses

    from repro_torch.models.programs import ModelProgram

    (pre_k, pre_r), (dec_k, dec_r), nxt = first_logits(prog, params, prompt)
    prog32 = ModelProgram(dataclasses.replace(prog.cfg, dtype="float32"))
    cast = lambda t: {k: cast(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.float()
    p32 = cast(params)
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    with torch.no_grad(), plain_path(), routing_log() as routed:
        pre_t, dec_t = prompt_logits(prog32, p32, toks, nxt)
    del p32
    out = {}
    if prog.cfg.moe is not None:
        out["free"] = {what: dict(kernel_vs_plain=rel_rms(k, r),
                                  kernel_vs_fp32=rel_rms(k, t),
                                  plain_vs_fp32=rel_rms(r, t))
                       for what, k, r, t in (("prefill", pre_k, pre_r, pre_t),
                                             ("decode", dec_k, dec_r, dec_t))}
        log(f"[{arch}] logits with each path's own routing (not gated): "
            f"{out['free']}")
        with torch.no_grad(), replay_experts(routed.calls):
            pre_k, dec_k = prompt_logits(prog, params, toks, nxt)
        with torch.no_grad(), replay_experts(routed.calls), plain_path():
            pre_r, dec_r = prompt_logits(prog, params, toks, nxt)
        log(f"[{arch}] both bf16 paths replay the fp32 run's experts:")
    for what, k, r, t in (("prefill", pre_k, pre_r, pre_t),
                          ("first decode", dec_k, dec_r, dec_t)):
        d, ek, er = rel_rms(k, r), rel_rms(k, t), rel_rms(r, t)
        max_abs = float((k.float() - r.float()).abs().max())
        log(f"[{arch}] {what} logits: kernel vs plain rel RMS {d:.3e} "
            f"(max abs {max_abs:.3e}); vs fp32: kernel {ek:.3e}, plain "
            f"{er:.3e}")
        if not (d <= TOL[torch.bfloat16] and ek <= 1.25 * er):
            raise AssertionError(f"{arch} {what} logits: kernel vs plain "
                                 f"rel RMS {d:.3e} (limit 5e-2), vs fp32 "
                                 f"{ek:.3e} against the plain path's "
                                 f"{er:.3e} (limit 1.25x)")
        key = what.split()[-1]
        out[f"{key}_logits_err"] = max_abs
        out[f"{key}_logits_rel_rms"] = dict(kernel_vs_plain=d,
                                            kernel_vs_fp32=ek,
                                            plain_vs_fp32=er)
    return out


def prompt_logits(prog, params, toks, nxt) -> tuple:
    """(prefill logits of ``toks``, logits of one decode step of ``nxt``
    against that prefill's own cache grown by 32 rows)."""
    pre, cache = prog.prefill(params, {"tokens": toks})
    dec, _ = prog.decode_step(params, grow_cache(cache, 32), {"tokens": nxt})
    return pre, dec


def full_width(arch: str, layers: int | None = None):
    """(config, program, seeded bf16 params, report) of ``arch`` at full
    width; ``layers`` cuts the depth."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.arena import tree_bytes
    from repro_torch.models.programs import ModelProgram

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    prog = ModelProgram(cfg)
    t0 = time.perf_counter()
    params = prog.init(0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()        # the fp32 draws' blocks
    param_bytes = tree_bytes(params)
    cut = f" (cut from {get_config(arch).n_layers})" if layers else ""
    log(f"[{arch}] {cfg.family}: {cfg.n_layers} layers{cut}, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {param_bytes / 1e9:.3f} GB "
        f"of bf16 weights drawn in {init_s:.1f}s")
    res = dict(arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
               layers_cut_from=get_config(arch).n_layers if layers else None,
               init_s=init_s, param_bytes=param_bytes)
    return cfg, prog, params, res


def phase_lm_path(arch: str, kernels: tuple, n_batched: int, *,
                  logits: str | None, profile: bool,
                  layers: int | None = None) -> dict:
    """One architecture's serving path at full width (``layers`` cuts the
    depth), from the port's seeded bf16 init: optionally the prefill and
    first decode logits, kernel path against plain path (``logits``:
    "direct", "fp32" or "rms", see logits_direct, logits_fp32 and
    logits_rms), and for an moe model the routing of the 128-token
    prompt (moe_routing); then register (slots 4, max_seq 1024), one
    ``generate`` per prompt (128 and 500 tokens, 32 new), and
    ``n_batched`` requests through one ``ContinuousBatcher``, whose tokens
    must equal the single-path tokens. The launch counters are set to 0
    just before the runtime run and read just after; each of ``kernels``
    must have moved."""
    from repro_torch.core import ContinuousBatcher, HydraRuntime, LMSpec

    cfg, prog, params, res = full_width(arch, layers)
    param_bytes = res["param_bytes"]
    tag = f"[{arch}]"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (128, 500)]
    if logits == "direct":
        res.update(logits_direct(prog, params, prompts[0], arch))
    elif logits == "fp32":
        res.update(logits_fp32(prog, params, prompts[0], arch))
    elif logits == "rms":
        res.update(logits_rms(prog, params, prompts[0], arch))
    if cfg.moe is not None:
        res["routing"] = moe_routing(prog, params, prompts[0], arch)
    prefill_ms = {}
    with torch.no_grad():
        for p in prompts:
            t = torch.tensor([p], dtype=torch.int32, device="cuda")
            prefill_ms[len(p)] = host_ms(lambda: prog.prefill(
                params, {"tokens": t}), iters=3)
        if "ssd_scan" in kernels:           # where a 500-token prefill goes
            t = torch.tensor([prompts[1]], dtype=torch.int32, device="cuda")
            res["prefill_profile"] = profile_device(
                lambda: prog.prefill(params, {"tokens": t}), 3,
                f"{arch} 500-token prefill")
    log(f"{tag} prefill ms by prompt length: {prefill_ms}")

    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0                     # this path's run starts here
    rt = HydraRuntime(device="cuda", memory_budget_bytes=max(
        16 << 30, param_bytes + (4 << 30)))
    try:
        t0 = time.perf_counter()
        spec = LMSpec(cfg=cfg, params=params, max_seq=1024, slots=4)
        rt.register_function(arch, spec)
        register_s = time.perf_counter() - t0
        single = [rt.generate(arch, p, max_new_tokens=32) for p in prompts]
        b = ContinuousBatcher(rt, arch)
        try:
            futs = [b.submit(prompts[i % 2], 32) for i in range(n_batched)]
            step_ms, decode_tokens = [], 0
            t0 = time.perf_counter()
            while b.active or b.pending:
                admits = bool(b.pending and b.free)
                n_active = len(b.active)
                ts = time.perf_counter()
                b.step()                    # ends in a host read of tokens
                if not admits:
                    step_ms.append((time.perf_counter() - ts) * 1e3)
                    decode_tokens += n_active
            wall_s = time.perf_counter() - t0
            outs = [f.result() for f in futs]
        finally:
            b.close()
        launches = {name: fn.launches for name, fn in counters.items()}
        if profile:
            b = ContinuousBatcher(rt, arch)
            try:
                for _ in range(4):
                    b.submit(prompts[0], 24)
                b.step()                    # admits all four slots
                res["decode_profile"] = profile_device(b.step, 8,
                                                       f"{arch} decode step")
                b.run_until_done()
            finally:
                b.close()
        res["exe_cache"] = rt.exe_cache.stats()
        res["arena"] = rt.arena_pool.stats()
    finally:
        rt.shutdown()

    for i, o in enumerate(outs):
        if o != single[i % 2]:
            raise AssertionError(f"{arch}: batched request {i} tokens {o} "
                                 f"!= single-path {single[i % 2]}")
    log(f"{tag} batched tokens equal single-path tokens for all "
        f"{len(outs)} requests (prompt lengths 128/500, 32 new tokens)")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{arch}: kernel {name} was never launched "
                                 f"on its serving path")
    n_prefills = len(prompts) + n_batched
    if "ssd_scan" in kernels and \
            launches["ssd_scan"] != cfg.n_layers * n_prefills:
        raise AssertionError(f"{arch}: {launches['ssd_scan']} ssd_scan "
                             f"launches, want {cfg.n_layers} per prefill x "
                             f"{n_prefills}")
    log(f"{tag} kernel launches on the serving path: {launches}")

    weights, state = step_bytes(cfg, params, prog, 4, 1024)
    med = float(np.median(step_ms))
    toks_total = sum(len(o) for o in outs)
    res.update(
        register_s=register_s, launches=launches, prefill_ms=prefill_ms,
        tokens=toks_total, wall_s=wall_s, tok_s=toks_total / wall_s,
        decode_steps=len(step_ms), decode_step_ms_median=med,
        decode_step_ms_min=min(step_ms),
        decode_tok_s=decode_tokens / (sum(step_ms) / 1e3),
        step_weight_bytes=weights, step_state_bytes=state,
        step_weight_bound_ms=weights / PEAK_BYTES_S * 1e3,
        step_bound_ms=(weights + state) / PEAK_BYTES_S * 1e3)
    log(f"{tag} registration {register_s * 1e3:.1f} ms; {toks_total} tokens "
        f"in {wall_s:.2f}s = {res['tok_s']:.1f} tok/s through the batcher; "
        f"decode step median {med:.2f} ms (min {min(step_ms):.2f}) beside "
        f"its bound {res['step_bound_ms']:.3f} ms ({weights / 1e9:.3f} GB "
        f"of weights read + {state / 1e9:.3f} GB of SSM state read and "
        f"written, / 3.35 TB/s); decode-only {res['decode_tok_s']:.1f} tok/s")
    del params
    torch.cuda.empty_cache()
    return res


def phase_frontend(arch: str, layers: int | None = None) -> dict:
    """A family whose inputs hold embeddings, at full width (``layers``
    cuts the depth), through ``ModelProgram``: a vlm prefills 4 rows of
    its ``frontend_tokens`` prefix embeddings before 500 - that many
    tokens and decodes on tokens; an audio model prefills 4 rows of 128
    frame embeddings and decodes on one frame each (embeddings seeded, at
    the token table's scale). 32 decode steps at 4 slots follow, each
    timed. Then the runtime: a vlm registers in a ``HydraRuntime`` and
    generates from tokens alone, as the reference serves it; an audio
    model's ``LMSpec`` must be refused at ``register_function`` with the
    budget untouched. The launch counters are set to 0 just before the
    kernel path's run and read just after; rmsnorm, flash and decode
    attention must have moved. The plain path then runs the same inputs:
    the prefill logits and every decode step's logits must lie within
    5e-2 of it in relative RMS."""
    from repro_torch.core import HydraRuntime, LMSpec

    cfg, prog, params, res = full_width(arch, layers)
    B, D, n_steps = 4, cfg.d_model, 32
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    emb = lambda *shape: randn(shape, torch.bfloat16, gen) * D ** -0.5
    toks = lambda *shape: torch.tensor(
        rng.integers(0, cfg.vocab_size, shape), dtype=torch.int32,
        device="cuda")
    if cfg.family == "audio":
        pre = {"embeds": emb(B, 128, D)}
        steps = [{"embeds": emb(B, 1, D)} for _ in range(n_steps)]
    else:
        ft = cfg.frontend_tokens
        pre = {"embeds": emb(B, ft, D), "tokens": toks(B, 500 - ft)}
        steps = [{"tokens": toks(B, 1)} for _ in range(n_steps)]

    def run():
        """(prefill logits, each decode step's logits, step ms)."""
        logits, cache = prog.prefill(params, pre)
        cache = grow_cache(cache, n_steps)
        out, ms = [], []
        for batch in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec, cache = prog.decode_step(params, cache, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(dec)
        return logits, out, ms

    counters = zero_launches()              # this path's run starts here
    with torch.no_grad():
        t0 = time.perf_counter()
        pre_k, dec_k, step_ms = run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        prefill_ms = host_ms(lambda: prog.prefill(params, pre), iters=2)
    rt = HydraRuntime(device="cuda", memory_budget_bytes=res["param_bytes"]
                      + (4 << 30))
    try:
        spec = LMSpec(cfg=cfg, params=params, max_seq=1024, slots=4)
        if cfg.family == "audio":
            try:
                rt.register_function(arch, spec)
            except TypeError as e:
                refusal = str(e)
            else:
                raise AssertionError(f"{arch}: an audio LMSpec registered")
            if rt.budget.used or len(rt.registry):
                raise AssertionError(f"{arch}: refused registration left "
                                     f"{rt.budget.used} bytes reserved")
            res.update(refused=refusal, budget_used_after=rt.budget.used)
            log(f"[{arch}] LMSpec refused at register_function: {refusal}; "
                f"budget used {rt.budget.used}")
        else:
            rt.register_function(arch, spec)
            prompt = rng.integers(0, cfg.vocab_size, 128).tolist()
            t0 = time.perf_counter()
            gen_toks = rt.generate(arch, prompt, max_new_tokens=32)
            res.update(generate_s=time.perf_counter() - t0,
                       generate_tokens=gen_toks)
            if len(gen_toks) != 32 or not all(
                    0 <= t < cfg.vocab_size for t in gen_toks):
                raise AssertionError(f"{arch}: generate gave {gen_toks}")
            log(f"[{arch}] tokens-only generate through HydraRuntime: 32 "
                f"tokens in {res['generate_s']:.2f}s: {gen_toks[:8]}...")
    finally:
        rt.shutdown()
    launches = check_launches(arch, counters, ATTENTION)

    with torch.no_grad(), plain_path():
        pre_r, dec_r, _ = run()
    pre_chk = check_rel_rms(f"{arch} prefill", pre_k, pre_r)
    dec_rms = [rel_rms(k, r) for k, r in zip(dec_k, dec_r)]
    dec_chk = check_rel_rms(f"{arch} decode step {int(np.argmax(dec_rms))}",
                            dec_k[int(np.argmax(dec_rms))],
                            dec_r[int(np.argmax(dec_rms))])
    weights, _ = step_bytes(cfg, params, prog, 4, 1024)
    med = float(np.median(step_ms))
    res.update(
        launches=launches, prefill_rows=B,
        prefill_positions=sum(t.shape[1] for t in pre.values()),
        prefill_ms=prefill_ms, run_s=run_s, decode_steps=n_steps,
        decode_step_ms_median=med, decode_step_ms_min=min(step_ms),
        decode_tok_s=B * n_steps / (sum(step_ms) / 1e3),
        step_weight_bytes=weights,
        step_bound_ms=weights / PEAK_BYTES_S * 1e3,
        prefill_logits_rel_rms=pre_chk["rel_rms"],
        prefill_logits_err=pre_chk["max_abs"],
        decode_logits_rel_rms_max=dec_chk["rel_rms"],
        decode_logits_rel_rms=dec_rms)
    log(f"[{arch}] prefill of {B} x {res['prefill_positions']} positions "
        f"{prefill_ms:.2f} ms; decode step median {med:.2f} ms (min "
        f"{min(step_ms):.2f}) beside its bound {res['step_bound_ms']:.3f} "
        f"ms ({weights / 1e9:.3f} GB of weights / 3.35 TB/s)")
    del params
    torch.cuda.empty_cache()
    return res


def host_ms(fn, iters: int = 3) -> float:
    """Host wall time of ``fn`` ending in a device sync, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


KERNEL_CLASSES = {   # profiler kernel-name keys of each hand-written kernel
    "rmsnorm": ("rmsnorm_kernel", "rmsnorm_scalar_kernel"),
    "flash_attention": ("flash_fwd", "flash_wgmma"),
    "decode_attention": ("decode_scores", "decode_pv", "decode_combine"),
    "ssd_scan": ("ssd_scan_kernel", "ssd_chunk_kernel", "ssd_state_kernel",
                 "ssd_out_kernel"),
    "rmsnorm_bwd": ("rmsnorm_bwd_kernel", "rmsnorm_dw_"),
    "flash_attention_bwd": ("flash_bwd_",),
}


def profile_device(fn, steps: int, what: str) -> dict:
    """Where the time of ``steps`` calls of ``fn`` goes: torch.profiler
    over them, device kernel time by class, the device's busy share of
    the wall time, kernels per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name, n = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / steps
            n += 1
    by_class = {c: 0.0 for c in list(KERNEL_CLASSES) + ["gemm", "other"]}
    for name, ms in by_name.items():
        cls = next((c for c, keys in KERNEL_CLASSES.items()
                    if any(key in name for key in keys)), None)
        if cls is None:
            low = name.lower()
            cls = "gemm" if ("gemm" in low or "cutlass" in low
                             or "nvjet" in low or "xmma" in low) else "other"
        by_class[cls] += ms
    busy = sum(by_name.values())
    res = dict(steps=steps, wall_ms_per_step=wall_ms,
               device_busy_ms_per_step=busy if n else "not measured",
               device_busy_share=busy / wall_ms if n else "not measured",
               kernels_per_step=n / steps, ms_per_step_by_class=by_class,
               top_kernels=sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    log(f"[profile] {what} under the profiler: {wall_ms:.2f} ms wall, "
        f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{n / steps:.0f} kernels each; by class (ms each) "
        f"{ {k: round(v, 3) for k, v in by_class.items()} }")
    return res


def _kernel_counters() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "decode_attention": decode_attention, "ssd_scan": ssd_scan,
            "rmsnorm_bwd": rmsnorm_bwd,
            "flash_attention_bwd": flash_attention_bwd}


# ---------------------------------------------------------------------------
# phase 5: the reduced closed-loop serve
# ---------------------------------------------------------------------------
def phase_serve() -> dict:
    from repro_torch.launch import serve
    s = serve.main(["--pool", "0", "--archs",
                    "qwen2.5-3b,mamba2-780m,zamba2-2.7b,granite-moe-1b-a400m",
                    "--tenants", "4", "--requests", "9"])
    if s["tokens"] <= 0:
        raise AssertionError("serve produced no tokens")
    return {k: s[k] for k in ("requests", "tokens", "wall_s")}


# ---------------------------------------------------------------------------
# phase 5a: training at full width
# ---------------------------------------------------------------------------
# the full-width run: the launcher's batch and sequence and AdamW with
# warmup_cosine; a short warmup, since 9 steps at the default lr (3e-4,
# 10 warmup steps) stay inside the batch-to-batch noise of the loss
TRAIN_ARGV = ["--arch", "qwen2.5-3b", "--full", "--steps", "9", "--lr",
              "1e-3", "--warmup", "3"]
TRAIN_STEPS = 8                    # n_micro 1, then one step of n_micro 2
GRAD_LAYERS = 4                    # the kernel-vs-plain gradient check


def train_setup(argv: list, layers: int | None = None):
    """(args, cfg, program, optimizer, params, opt state) from the
    launcher's own pieces: its flags, ``build`` and the port's seeded
    init (fp32 masters); ``layers`` cuts the depth."""
    import dataclasses

    from repro_torch.launch import train
    from repro_torch.models.programs import ModelProgram

    args = train.parse_args(argv)
    cfg, prog, opt = train.build(args)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        prog = ModelProgram(cfg, remat=args.remat)
    params = prog.init(0, device="cuda")
    return args, cfg, prog, opt, params, opt.init(params)


def train_batches(cfg, args, steps: int) -> list:
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import train
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_size=args.batch)
    return [train.make_batch(cfg, args, s, make_batch(data, s), "cuda")
            for s in range(steps)]


def leaf_probe(params) -> list:
    """The first 4096 elements of every leaf, copied: enough to see that a
    step moved each leaf without holding a second model."""
    from repro_torch.core.arena import tree_leaves
    return [p.reshape(-1)[:4096].clone() for p in tree_leaves(params)]


def timed_step(step, params, opt_state, batch) -> tuple:
    """(metrics, host ms of one train step ending in the loss's read)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, mets = step(params, opt_state, batch)
    float(mets["loss"])
    return mets, (time.perf_counter() - t0) * 1e3


def train_full_width() -> dict:
    """qwen2.5-3b at full width (36 layers): 8 steps of n_micro 1 (the
    last one under the profiler), then one of n_micro 2 (module
    docstring)."""
    from repro_torch.core.arena import tree_bytes
    from repro_torch.core.arena import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    args, cfg, prog, opt, params, opt_state = train_setup(TRAIN_ARGV)
    n_params = sum(p.numel() for p in tree_leaves(params))
    batches = train_batches(cfg, args, TRAIN_STEPS + 1)
    L = cfg.n_layers
    log(f"[train] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params, fp32 masters "
        f"{tree_bytes(params) / 1e9:.2f} GB, batch {args.batch} x seq "
        f"{args.seq}, lr {args.lr} warmup {args.warmup}")
    counters = zero_launches()
    step = prog.make_train_step(opt, n_micro=1)
    losses, step_ms, moved, profile = [], [], [], None
    for s in range(TRAIN_STEPS):
        before = leaf_probe(params)
        if s == TRAIN_STEPS - 1:
            held = {}
            profile = profile_device(
                lambda: held.update(m=step(params, opt_state, batches[s])[2]),
                1, "qwen2.5-3b train step")
            mets = held["m"]
        else:
            mets, ms = timed_step(step, params, opt_state, batches[s])
            step_ms.append(ms)
        moved.append(sum(not torch.equal(a, b) for a, b in
                         zip(before, leaf_probe(params))))
        losses.append(float(mets["loss"]))
        log(f"[train] step {s} loss {losses[-1]:.4f} grad_norm "
            f"{float(mets['grad_norm']):.4f} lr {float(mets['lr']):.3e}")
    per_step = {n: fn.launches / TRAIN_STEPS for n, fn in counters.items()}
    want = {"rmsnorm": 2 * L + 1, "rmsnorm_bwd": 2 * L + 1,
            "flash_attention": L, "flash_attention_bwd": L}
    for name, n in want.items():
        if per_step[name] != n:
            raise AssertionError(f"train: {per_step[name]} {name} launches "
                                 f"per step, want {n}")
    del step
    torch.cuda.empty_cache()       # the n_micro 1 step's gradient buffer
    step2 = prog.make_train_step(opt, n_micro=2)
    before = leaf_probe(params)
    mets, micro2_ms = timed_step(step2, params, opt_state,
                                 batches[TRAIN_STEPS])
    moved.append(sum(not torch.equal(a, b) for a, b in
                     zip(before, leaf_probe(params))))
    losses.append(float(mets["loss"]))
    log(f"[train] step {TRAIN_STEPS} (n_micro 2) loss {losses[-1]:.4f} in "
        f"{micro2_ms:.1f} ms")
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    leaf_bytes = tree_bytes(params)
    del step2, params, opt_state, batches
    torch.cuda.empty_cache()

    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite loss in {losses}")
    if not float(np.mean(losses[-3:])) < losses[0]:
        raise AssertionError(f"train: the mean of the last 3 losses "
                             f"{np.mean(losses[-3:]):.4f} is not below the "
                             f"first {losses[0]:.4f}: {losses}")
    if not all(moved):
        raise AssertionError(f"train: a step moved no parameter: {moved}")
    if not peak < total:
        raise AssertionError(f"train: max_memory_allocated {peak} >= the "
                             f"card's {total}")
    tokens = args.batch * args.seq
    flops_ms = 6.0 * n_params * tokens / PEAK_FLOPS[torch.bfloat16] * 1e3
    adamw_ms = 7 * 4 * n_params / PEAK_BYTES_S * 1e3   # p,g,m,v in; p,m,v out
    med = float(np.median(step_ms[1:]))
    res = dict(arch=cfg.name, n_layers=L, n_params=n_params, tokens=tokens,
               lr=args.lr, warmup=args.warmup, losses=losses,
               leaves_moved_per_step=moved,
               step_ms=step_ms, step_ms_median=med, micro2_step_ms=micro2_ms,
               launches=launches, launches_per_step=per_step,
               max_memory_allocated=peak, device_total_memory=total,
               state_bytes=dict(params=leaf_bytes, grads=leaf_bytes,
                                m=leaf_bytes, v=leaf_bytes),
               bound_ms=dict(flops_6NT=flops_ms, adamw_bytes=adamw_ms,
                             total=flops_ms + adamw_ms),
               profile=profile)
    log(f"[train] losses {[round(x, 4) for x in losses]}; step median "
        f"{med:.1f} ms (steps 1-{TRAIN_STEPS - 2}; step 0 "
        f"{step_ms[0]:.1f} ms) beside its bound {flops_ms + adamw_ms:.1f} "
        f"ms (6 N T = {6.0 * n_params * tokens:.3e} flops / 989 TFLOP/s = "
        f"{flops_ms:.1f} ms + AdamW's {7 * 4 * n_params / 1e9:.1f} GB / "
        f"3.35 TB/s = {adamw_ms:.1f} ms); max_memory_allocated "
        f"{peak / 1e9:.2f} GB of {total / 1e9:.2f} GB; launches per step "
        f"{per_step}")
    return res


def train_grad_check() -> dict:
    """Full width cut to GRAD_LAYERS layers: every parameter's gradient
    of one loss on the kernel path (forward and backward kernels) against
    the plain path (autograd of the plain versions), same weights and
    batch. Gate: relative RMS <= 5e-2 (the bf16 tolerance) per leaf."""
    from repro_torch.ft.checkpoint import _flatten
    from repro_torch.kernels import ops

    args, cfg, prog, _, params, _ = train_setup(TRAIN_ARGV, GRAD_LAYERS)
    batch = train_batches(cfg, args, 1)[0]
    grads, losses = {}, {}
    for mode in (None, "ref"):
        ops.set_kernel_mode(mode)
        try:
            leaves = _flatten(params)
            for p in leaves.values():
                p.requires_grad_(True)
                p.grad = None
            loss, _ = prog.loss_fn(params, batch)
            loss.backward()
        finally:
            ops.set_kernel_mode(None)
        losses[mode] = float(loss.detach())
        grads[mode] = {k: p.grad.float() for k, p in leaves.items()}
        for p in leaves.values():
            p.grad = None
            p.requires_grad_(False)
    out = {}
    for key, gp in grads["ref"].items():
        gk = grads[None][key]
        out[key] = dict(rel_rms=rel_rms(gk, gp), plain_norm=float(gp.norm()),
                        kernel_norm=float(gk.norm()))
    bad = {k: r["rel_rms"] for k, r in out.items()
           if not r["rel_rms"] <= TOL[torch.bfloat16]}
    log(f"[train] {GRAD_LAYERS}-layer full-width gradients, kernel vs plain "
        f"path, relative RMS per leaf: "
        f"{ {k: round(r['rel_rms'], 5) for k, r in out.items()} }; loss "
        f"kernel {losses[None]:.5f} plain {losses['ref']:.5f}")
    del params, grads
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"train: gradients beyond 5e-2 relative RMS of "
                             f"the plain path: {bad}")
    return dict(layers=GRAD_LAYERS, layers_cut_from=36, losses=dict(
        kernel=losses[None], plain=losses["ref"]), leaves=out)


def train_short(arch: str, steps: int = 2) -> dict:
    """``arch`` at full width: ``steps`` train steps from the launcher's
    pieces (batch 8, seq 128); gate: finite losses."""
    argv = ["--arch", arch, "--full", "--steps", str(steps), "--lr", "1e-3",
            "--warmup", "3"]
    counters = zero_launches()
    args, cfg, prog, opt, params, opt_state = train_setup(argv)
    batches = train_batches(cfg, args, steps)
    step = prog.make_train_step(opt)
    losses, ms = [], []
    for b in batches:
        mets, t = timed_step(step, params, opt_state, b)
        losses.append(float(mets["loss"]))
        ms.append(t)
    launches = check_launches(f"train {arch}", counters, (
        "rmsnorm", "flash_attention", "rmsnorm_bwd", "flash_attention_bwd"))
    del step, params, opt_state, batches
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train {arch}: non-finite loss in {losses}")
    log(f"[train] {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}): "
        f"losses {losses}, step ms {[round(t, 1) for t in ms]}")
    return dict(arch=arch, n_layers=cfg.n_layers, losses=losses, step_ms=ms,
                launches=launches)


def train_drill(tmp: str) -> dict:
    """The restart drill through the launcher: reduced qwen2.5-3b, 18
    steps, a failure injected at step 12, checkpoints every 5 steps;
    gate: it restores and resumes, and every loss is finite."""
    import contextlib
    import io

    from repro_torch.launch import train

    counters = zero_launches()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        losses = train.main(["--arch", "qwen2.5-3b", "--reduced", "--steps",
                             "18", "--batch", "2", "--seq", "32",
                             "--fail-at", "12", "--ckpt-dir",
                             os.path.join(tmp, "drill"), "--ckpt-every",
                             "5"])
    out = text.getvalue()
    launches = check_launches("train drill", counters, (
        "rmsnorm", "flash_attention", "rmsnorm_bwd", "flash_attention_bwd"))
    restored = re.search(r"restored step (\d+), resuming at (\d+)", out)
    if not restored or not all(np.isfinite(losses)) or \
            len(losses) < 18 - 11:
        raise AssertionError(f"train drill: no resume, or non-finite "
                             f"losses: {out[-2000:]}")
    log(f"[train] drill: failure at step 12, restored step "
        f"{restored.group(1)} and resumed at {restored.group(2)}; "
        f"{len(losses)} losses, first {losses[0]:.4f} last {losses[-1]:.4f}")
    return dict(restored_step=int(restored.group(1)),
                resumed_at=int(restored.group(2)), losses=losses,
                launches=launches)


def train_refusal() -> dict:
    """An ssm model cannot train on the card yet: a train step on reduced
    mamba2-780m raises the ssd_scan backward's NotImplementedError before
    it runs, with every parameter unchanged, and so does the launcher."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.programs import ModelProgram
    from repro_torch.optim import AdamW, constant

    cfg = get_config("mamba2-780m").reduced()
    prog = ModelProgram(cfg)
    params = prog.init(0, device="cuda")
    sums = checksums(params)
    opt = AdamW(lr=constant(1e-3))
    toks = torch.zeros((2, 32), dtype=torch.int32, device="cuda")
    msgs = []
    for call in (lambda: prog.make_train_step(opt)(
                     params, opt.init(params), {"tokens": toks,
                                                "labels": toks}),
                 lambda: train.main(["--arch", "mamba2-780m", "--reduced",
                                     "--steps", "2"])):
        try:
            call()
        except NotImplementedError as e:
            if "ssd_scan" not in str(e):
                raise
            msgs.append(str(e))
        else:
            raise AssertionError("train: mamba2-780m trained on the card")
    if checksums(params) != sums:
        raise AssertionError("train: the refused step changed a parameter")
    log(f"[train] mamba2-780m refused on the card (step and launcher), "
        f"parameters unchanged: {msgs[0]}")
    return dict(refused=True, message=msgs[0])


def phase_train(tmp: str) -> dict:
    """Phase 5a (module docstring)."""
    res = dict(qwen=train_full_width())
    res["grad_check"] = train_grad_check()
    for arch in ("gemma3-1b", "granite-moe-1b-a400m"):
        res[arch] = train_short(arch)
    res["drill"] = train_drill(tmp)
    res["refusal"] = train_refusal()
    return res


# ---------------------------------------------------------------------------
# phases 6-7: the platform and the cluster at full width
# ---------------------------------------------------------------------------
GiB = 1 << 30


def checksums(params) -> dict:
    """Per leaf, two sums over its raw 16- or 32-bit words (plain and
    position-weighted), on the card: equal checksums mean bit-equal leaves
    for any realistic corruption, without copying 7 GB to the host."""
    from repro_torch.ft.checkpoint import _flatten
    out = {}
    for key, t in _flatten(params).items():
        v = t.reshape(-1).view(torch.int16 if t.element_size() == 2
                               else torch.int32)
        s1 = s2 = 0
        for i in range(0, v.numel(), 1 << 26):
            c = v[i:i + (1 << 26)].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
            s1 += int(c.sum())
            s2 += int((c * w).sum())
        out[key] = (s1, s2)
    return out


def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def allocated() -> int:
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def build_dir_state() -> dict:
    """{library file: mtime} of the built kernels: unchanged across a run
    means no nvcc ran in it."""
    from repro_torch.kernels import _build
    return {p.name: p.stat().st_mtime_ns
            for p in _build.BUILD_DIR.glob("*.so")}


def zero_launches() -> dict:
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def check_launches(what: str, counters: dict, kernels: tuple) -> dict:
    launches = {name: fn.launches for name, fn in counters.items()}
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{what}: kernel {name} was never launched")
    log(f"[{what}] kernel launches: {launches}")
    return launches


def phase_platform(snap_root: str) -> dict:
    """Phase 6 (module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.core import HydraPlatform, LMSpec, PlatformParams
    from repro_torch.core.arena import tree_bytes
    from repro_torch.ft.checkpoint import _flatten, dtype_name
    from repro_torch.launch.serve import make_params

    arch = "qwen2.5-3b"
    cfg = get_config(arch)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               128).tolist()
    params = {t: make_params(cfg, seed=i, device="cuda")
              for i, t in enumerate(("tenantA", "tenantB"))}
    weight_bytes = tree_bytes(params["tenantA"])
    sums = checksums(params["tenantA"])
    leaves = {k: {"shape": list(v.shape), "dtype": dtype_name(v.dtype)}
              for k, v in _flatten(params["tenantA"]).items()}
    snap_dir = os.path.join(snap_root, "platform")
    pp = dict(pool_size=2, runtime_budget_bytes=16 * GiB,
              snapshot_dir=snap_dir, device="cuda")
    res = dict(arch=arch, weight_bytes=weight_bytes, **{
        k: v for k, v in pp.items() if k != "snapshot_dir"})
    fid = {t: f"{t}/{arch}" for t in params}

    counters = zero_launches()              # this path's run starts here
    plat = HydraPlatform(PlatformParams(**pp))
    try:
        plat.register_function(fid["tenantA"], LMSpec(
            cfg=cfg, params=params.pop("tenantA"), max_seq=1024, slots=4),
            tenant="tenantA", eager=True)
        before = plat.generate(fid["tenantA"], prompt, 32)
        one_tenant = plat.exe_cache.stats()["compiles"]
        plat.register_function(fid["tenantB"], LMSpec(
            cfg=cfg, params=params.pop("tenantB"), max_seq=1024, slots=4),
            tenant="tenantB", eager=True)
        plat.generate(fid["tenantB"], prompt, 32)
        res["placement"] = plat.placement()
        res["compiles_one_tenant"] = one_tenant
        res["compiles_two_tenants"] = plat.exe_cache.stats()["compiles"]
        if len(set(res["placement"].values())) != 1:
            raise AssertionError(f"platform: two tenants of {arch} did not "
                                 f"pack into one runtime: {res['placement']}")
        if res["compiles_two_tenants"] != one_tenant:
            raise AssertionError("platform: the second tenant built "
                                 "programs of its own")

        t0 = time.perf_counter()
        plat.snapshot(fid["tenantA"])
        res["snapshot_s"] = time.perf_counter() - t0
        root = plat._record(fid["tenantA"]).snapshot_path
        res["snapshot_bytes"] = dir_bytes(root)
        mem0 = allocated()
        plat.evict(fid["tenantA"])
        mem1 = allocated()
        compiles = plat.exe_cache.stats()["compiles"]
        t0 = time.perf_counter()
        plat.restore(fid["tenantA"])
        torch.cuda.synchronize()
        res["restore_wall_s"] = time.perf_counter() - t0
        res["restore_s"] = plat.metrics.hists["restore_s"].mean
        mem2 = allocated()
        after = plat.generate(fid["tenantA"], prompt, 32)
        restored = checksums(plat._record(fid["tenantA"]).spec.params)
        res.update(allocated_before_evict=mem0, allocated_after_evict=mem1,
                   allocated_after_restore=mem2,
                   reserved=torch.cuda.memory_reserved(),
                   evict_freed_share=(mem0 - mem1) / weight_bytes,
                   tokens=before, launches=check_launches(
                       "platform", counters, ATTENTION))
        if after != before:
            raise AssertionError(f"platform: tokens after restore {after} "
                                 f"!= before {before}")
        if plat.exe_cache.stats()["compiles"] != compiles:
            raise AssertionError("platform: restore built a program")
        if restored != sums:
            bad = [k for k in sums if restored[k] != sums[k]]
            raise AssertionError(f"platform: restored leaves differ: {bad}")
        if mem0 - mem1 < 0.9 * weight_bytes or mem2 - mem1 < 0.9 * weight_bytes:
            raise AssertionError(
                f"platform: memory_allocated {mem0} -> {mem1} at eviction, "
                f"-> {mem2} at restore; weights are {weight_bytes} bytes")
        log(f"[platform] {arch} x2 tenants in one runtime "
            f"({res['placement']}), {one_tenant} programs for one tenant "
            f"and for two; evict/restore tokens equal, no new program, "
            f"{len(sums)} leaves bit-equal (checksums)")
        log(f"[platform] memory_allocated {mem0 / 1e9:.3f} GB -> "
            f"{mem1 / 1e9:.3f} GB at eviction ({100 * res['evict_freed_share']:.1f}% "
            f"of the {weight_bytes / 1e9:.3f} GB of weights) -> "
            f"{mem2 / 1e9:.3f} GB at restore; memory_reserved "
            f"{res['reserved'] / 1e9:.3f} GB (the caching allocator keeps "
            f"its blocks)")

        exported = plat.export_function(fid["tenantA"])
        res["child"] = fresh_process_restore(snap_dir, exported, leaves,
                                             prompt, pp)
        if res["child"]["tokens"] != before:
            raise AssertionError(f"platform: the fresh process's tokens "
                                 f"{res['child']['tokens']} != {before}")
    finally:
        plat.shutdown()
    gb = res["snapshot_bytes"] / 1e9
    c = res["child"]
    log(f"[platform] snapshot {gb:.3f} GB in {res['snapshot_s']:.2f}s "
        f"({gb / res['snapshot_s']:.2f} GB/s); in-process restore "
        f"{res['restore_s']:.2f}s ({gb / res['restore_s']:.2f} GB/s; "
        f"{res['restore_wall_s']:.2f}s with placement); fresh-process "
        f"restore {c['restore_s']:.2f}s ({gb / c['restore_s']:.2f} GB/s), "
        f"interpreter start to first token {c['start_to_first_token_s']:.2f}s "
        f"(imports {c['import_s']:.2f}s)")
    return res


def fresh_process_restore(snap_dir, exported, leaves, prompt, pp) -> dict:
    """A child process on the same card imports ``exported`` and restores
    it from the snapshot; it must build no program and no kernel library."""
    meta = dict(snapshot_dir=snap_dir, leaves=leaves, prompt=prompt,
                platform={k: v for k, v in pp.items() if k != "snapshot_dir"},
                **{k: exported[k] for k in ("fid", "tenant", "mem_budget",
                                            "need_bytes", "invocations",
                                            "snapshot_path")},
                max_seq=exported["spec"].max_seq, slots=exported["spec"].slots,
                arch=exported["spec"].cfg.name)
    meta_path = os.path.join(snap_dir, "export.json")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    libs = build_dir_state()
    t_spawn = time.time()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--restore-child", meta_path, repr(t_spawn)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"fresh-process restore failed:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["wall_s"] = time.time() - t_spawn
    out["kernel_libraries_rebuilt"] = sorted(
        k for k, v in build_dir_state().items() if libs.get(k) != v)
    exe = out["exe_cache"]
    if exe["compiles"] != 0 or exe["disk_hits"] < 1 or \
            out["kernel_libraries_rebuilt"]:
        raise AssertionError(f"fresh-process restore built something: {out}")
    log(f"[platform] fresh process: compiles {exe['compiles']}, disk hits "
        f"{exe['disk_hits']}, kernel libraries rebuilt "
        f"{out['kernel_libraries_rebuilt']}, {out['wall_s']:.2f}s in all")
    return out


def restore_child(meta_path: str, t_spawn: float) -> int:
    """The fresh process of phase 6: import the exported record, restore
    it from the snapshot, generate; print one JSON line."""
    from repro_torch.configs import get_config
    from repro_torch.core import HydraPlatform, LMSpec, PlatformParams

    t_import = time.time()
    with open(meta_path) as f:
        meta = json.load(f)
    template = {}
    for key, leaf in meta["leaves"].items():
        *head, last = key.split("/")
        d = template
        for h in head:
            d = d.setdefault(h, {})
        d[last] = torch.empty(leaf["shape"],
                              dtype=getattr(torch, leaf["dtype"]),
                              device="meta")
    spec = LMSpec(cfg=get_config(meta["arch"]), params=None,
                  max_seq=meta["max_seq"], slots=meta["slots"])
    plat = HydraPlatform(PlatformParams(snapshot_dir=meta["snapshot_dir"],
                                        **meta["platform"]))
    try:
        plat.import_function(dict(
            spec=spec, params_spec=template,
            **{k: meta[k] for k in ("fid", "tenant", "mem_budget",
                                    "need_bytes", "invocations",
                                    "snapshot_path")}))
        plat.restore(meta["fid"])
        first = plat.generate(meta["fid"], meta["prompt"], 1)
        t_first = time.time()
        toks = plat.generate(meta["fid"], meta["prompt"], 32)
        if toks[:1] != first:
            raise AssertionError(f"first token {first} != {toks[:1]}")
        print(json.dumps(dict(
            tokens=toks, exe_cache=plat.exe_cache.stats(),
            restore_s=plat.metrics.hists["restore_s"].mean,
            import_s=t_import - t_spawn,
            start_to_first_token_s=t_first - t_spawn)))
    finally:
        plat.shutdown()
    return 0


def phase_cluster(snap_root: str) -> dict:
    """Phase 7 (module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.core import (ClusterParams, HydraCluster, LMSpec,
                                  PlatformParams, estimate_bytes)
    from repro_torch.launch.serve import make_params

    archs = ("qwen2.5-3b", "mamba2-780m")
    rng = np.random.default_rng(1)
    cfgs = {a: get_config(a) for a in archs}
    prompt = {a: rng.integers(0, c.vocab_size, 128).tolist()
              for a, c in cfgs.items()}
    fid = {a: f"t0/{a}" for a in archs}
    params = {a: make_params(c, seed=0, device="cuda")
              for a, c in cfgs.items()}
    node_bytes = 8 * GiB
    counters = zero_launches()              # this path's run starts here
    cl = HydraCluster(ClusterParams(
        n_nodes=2, node_memory_bytes=node_bytes,
        snapshot_dir=os.path.join(snap_root, "cluster"),
        platform=PlatformParams(pool_size=1, runtime_budget_bytes=node_bytes,
                                device="cuda")))
    res = dict(n_nodes=2, node_memory_bytes=node_bytes)
    try:
        need = {}
        for a in archs:
            spec = LMSpec(cfg=cfgs[a], params=params.pop(a), max_seq=1024,
                          slots=4)
            need[a] = estimate_bytes(spec)
            cl.register_function(fid[a], spec, tenant="t0", eager=True)
            del spec
        res["estimate_bytes"] = need
        res["placement"] = {a: cl.placement()[fid[a]] for a in archs}
        if res["placement"] != {"qwen2.5-3b": 0, "mamba2-780m": 1} or \
                cl.metrics.counters["place.spill"] != 1:
            raise AssertionError(f"cluster: placement {res['placement']}, "
                                 f"metrics {dict(cl.metrics.counters)}")
        before = {a: cl.generate(fid[a], prompt[a], 32) for a in archs}
        compiles = cl.exe_cache.stats()["compiles"]
        a = "mamba2-780m"
        t0 = time.perf_counter()
        nbytes = cl.migrate(fid[a], 0)
        torch.cuda.synchronize()
        res["migrate_s"] = time.perf_counter() - t0
        dst = cl.nodes[0].platform._snapshot_root(fid[a])
        res.update(migrated=a, transfer_bytes=nbytes,
                   snapshot_bytes=dir_bytes(dst),
                   modeled_transfer_s=cl.metrics.hists["transfer_s"].mean,
                   # the parts of migrate_s: the source's snapshot write
                   # and the destination's read and copy to the card
                   export_snapshot_s=cl.nodes[1].platform.metrics.hists[
                       "snapshot_s"].mean,
                   import_restore_s=cl.nodes[0].platform.metrics.hists[
                       "restore_s"].mean,
                   committed_after={n.idx: n.committed for n in cl.nodes})
        after = {a: cl.generate(fid[a], prompt[a], 32) for a in archs}
        res.update(tokens=before, placement_after=cl.placement(),
                   compiles=compiles, launches=check_launches(
                       "cluster", counters, ATTENTION + ("ssd_scan",)))
        if after != before:
            raise AssertionError(f"cluster: tokens after migration {after} "
                                 f"!= before {before}")
        if cl.exe_cache.stats()["compiles"] != compiles:
            raise AssertionError("cluster: migration built a program")
        if not (nbytes == res["snapshot_bytes"]
                == cl.metrics.counters["transfer_bytes"]):
            raise AssertionError(f"cluster: transfer_bytes {nbytes} != "
                                 f"snapshot {res['snapshot_bytes']}")
        if cl.placement()[fid[a]] != 0:
            raise AssertionError("cluster: migration did not move it")
    finally:
        cl.shutdown()
    log(f"[cluster] qwen2.5-3b ({need['qwen2.5-3b'] / 1e9:.2f} GB estimate) "
        f"on node 0, mamba2-780m ({need['mamba2-780m'] / 1e9:.2f} GB) "
        f"spilled to node 1 under an {node_bytes / 1e9:.2f} GB node budget; "
        f"migrated to node 0 in {res['migrate_s']:.2f}s "
        f"({nbytes / 1e9:.3f} GB snapshot, "
        f"{nbytes / 1e9 / res['migrate_s']:.2f} GB/s; of it snapshot write "
        f"{res['export_snapshot_s']:.2f}s, restore "
        f"{res['import_restore_s']:.2f}s; modeled transfer "
        f"{res['modeled_transfer_s']:.2f}s at 10 Gb/s); both serve the same "
        f"tokens after it, no new program (migrate, as the reference's, "
        f"does not re-check the destination's budget: committed "
        f"{res['committed_after']})")
    return res


# ---------------------------------------------------------------------------
# phase 8: the live serving gateway
# ---------------------------------------------------------------------------
AZURE = os.path.join(ROOT, "benchmarks", "data", "azure_sample.csv")
GATEWAY_PHASES = ("pool_claim", "register", "arena_acquire.cold",
                  "arena_acquire.zeroed", "arena_acquire.reuse", "dispatch",
                  "compute")
# the probe's wall-second costs and the SimParams field each calibrates
CALIBRATION_COSTS = {"runtime_boot_s": "hydra_runtime_cold_s",
                     "register_s": "fn_register_s",
                     "pool_claim_s": "pool_claim_s",
                     "restore_s": "snapshot_restore_s"}


def check_warmed(leg: str, warm: dict, compiles: int) -> int:
    """The replay's warm-up must have reached every executable cache on
    the card, and nothing may compile on the clock; returns the compiles
    after the warm-up, as measured."""
    after = compiles - sum(warm["compiles_before_clock"])
    log(f"[gateway {leg}] warm-up: {warm['warmed']}/{warm['caches']} "
        f"caches warmed; {compiles} compiles, {after} after the warm-up")
    if warm["caches"] < 1 or warm["warmed"] != warm["caches"] or after:
        raise AssertionError(f"gateway {leg}: warm-up {warm} left "
                             f"{after} compiles on the clock")
    return after


def leg_numbers(leg: str, live: dict, extras: dict, compress: float) -> dict:
    """The numbers one gateway leg reports, from the live ``SimResult``
    summary and the replay's extras."""
    phases = (extras.get("tracing") or {}).get("phases", {})
    costs = extras.get("probe", {}).get("wall_costs", {})
    compiles = extras["exe_cache"]["compiles"]
    after = check_warmed(leg, extras["warm"], compiles)
    return {
        "requests": live["requests"], "dropped": live["dropped"],
        "submitted": extras["submitted"],
        "cold_runtime": live["cold_runtime"],
        "pool_claims": live["pool_claims"],
        "p50_s": live["p50_s"], "p99_s": live["p99_s"],
        "p50_wall_ms": live["p50_s"] / compress * 1e3,
        "p99_wall_ms": live["p99_s"] / compress * 1e3,
        "request_overhead_ms": extras["request_overhead_ms"],
        "phases_ms": {k: {q: phases[k][q] for q in ("count", "p50_ms",
                                                    "p99_ms")}
                      for k in GATEWAY_PHASES if k in phases},
        "compiles": compiles, "compiles_after_warmup": after,
        "warm": extras["warm"],
        "calibration_wall_s": {k: (costs[k]["mean"] if costs.get(k) else None)
                               for k in CALIBRATION_COSTS},
        "boots_in_window": (costs.get("runtime_boot_s") or {}).get("count", 0),
        "errors": extras["errors"][:3], "n_errors": len(extras["errors"]),
        "mean_mem_mb": live["mean_mem_mb"], "peak_mem_mb": live["peak_mem_mb"],
        "ops_per_gb_s": live["ops_per_gb_s"],
        "wall_s": extras["wall_s"], "late_arrivals": extras["late_arrivals"],
    }


def log_leg(name: str, r: dict) -> None:
    log(f"[gateway {name}] {r['requests']} served + {r['dropped']} dropped "
        f"of {r['submitted']}; cold_runtime {r['cold_runtime']}, "
        f"pool_claims {r['pool_claims']}; p50 {r['p50_s']:.4f} trace s "
        f"({r['p50_wall_ms']:.2f} wall ms), p99 {r['p99_s']:.4f} trace s "
        f"({r['p99_wall_ms']:.2f} wall ms); request overhead "
        f"{r['request_overhead_ms']}; compiles {r['compiles']} "
        f"({r['compiles_after_warmup']} after the warm-up)")
    for k, v in r.get("phases_ms", {}).items():
        log(f"[gateway {name}]   {k}: n={v['count']} p50 {v['p50_ms']} ms "
            f"p99 {v['p99_ms']} ms")
    log(f"[gateway {name}] calibration (wall s): {r['calibration_wall_s']}")
    if "deltas" in r:
        log(f"[gateway {name}] live - sim: "
            + ", ".join(f"{k} {d['live']} - {d['sim']}"
                        for k, d in r["deltas"].items()))


def validated_leg(name: str, trace, **kw) -> dict:
    """One ``run_validation`` leg on the card; every gate must pass."""
    from repro_torch.gateway import format_report, run_validation
    report = run_validation(trace, device="cuda", round_trip=True,
                            attribute=True, **kw)
    log(format_report(report))
    if not report["ok"]:
        raise AssertionError(f"gateway {name}: {report['failures']}")
    rt = report["round_trip"]
    for gate in (report["gates"]["cold_runtime"], report["gates"]["p99_s"],
                 rt["cold_runtime"], rt["p99_s"]):
        if not gate["passed"]:
            raise AssertionError(f"gateway {name}: gate failed: {gate}")
    r = leg_numbers(name, report["live"], report["extras"], kw["compress"])
    r.update(gates=report["gates"], round_trip=rt,
             deltas={k: d for k, d in report["deltas"].items()},
             attribution=report.get("attribution"),
             calibration=report["calibration"]["measured"])
    log_leg(name, r)
    return r


def traced_export(trace_dir: str) -> dict:
    """The first 3 trace minutes replayed with every request traced; the
    Chrome export must pass the tracing module's own checker, run as a
    child process."""
    from repro_torch.core import HydraPlatform, PlatformParams
    from repro_torch.core.tracing import Tracer, export_chrome
    from repro_torch.gateway import ReplayConfig, load_trace, replay_trace
    trace = load_trace(AZURE, max_minutes=3)
    plat = HydraPlatform(PlatformParams(
        pool_size=4, runtime_budget_bytes=32 << 20, arena_ttl_s=10.0 / 60,
        n_workers=4, device="cuda"))
    tracer = Tracer(1.0, seed=0)
    try:
        live, extras = replay_trace(
            trace, plat, ReplayConfig(compress=60.0, n_workers=8,
                                      autoscale=False), tracer=tracer)
    finally:
        plat.shutdown()
    check_warmed("a traced", extras["warm"], extras["exe_cache"]["compiles"])
    path = os.path.join(trace_dir, "gateway_spans.json")
    doc = export_chrome(tracer, path, meta={"trace_file": AZURE})
    out = subprocess.run([sys.executable, "-m", "repro_torch.core.tracing",
                          "--check", path], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=os.path.join(
                             ROOT, "src")))
    log(f"[gateway a] traced replay of {live.summary()['requests']} "
        f"requests: {len(doc['traceEvents'])} trace events; --check rc "
        f"{out.returncode}: {out.stdout.strip()[-300:]}")
    if out.returncode != 0 or extras["errors"]:
        raise AssertionError(f"gateway: span export check failed: "
                             f"{out.stdout[-1000:]} {out.stderr[-1000:]} "
                             f"{extras['errors'][:3]}")
    return {"requests": live.summary()["requests"],
            "trace_events": len(doc["traceEvents"]),
            "check_rc": out.returncode}


def cluster_leg(tmp: str) -> dict:
    """Leg (c): the normal entry point on a two-node cluster, as a child
    process."""
    from repro_torch.core.calibrate import load_calibration
    cal = os.path.join(tmp, "cal.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--gateway",
           "--trace-file", AZURE, "--compress", "120", "--nodes", "2",
           "--snapshot-dir", os.path.join(tmp, "snap"), "--calibration", cal]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=os.path
                                               .join(ROOT, "src")))
    wall = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    for line in lines:
        if line.startswith("[gateway]"):
            log(f"[gateway c] {line}")
    if out.returncode != 0:
        raise AssertionError(f"gateway c: serve exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    # the summary is the JSON object the child prints last
    start = max(i for i, line in enumerate(lines) if line == "{")
    live = json.loads("\n".join(lines[start:]))
    m = re.search(r"served (\d+)/(\d+) requests", out.stdout)
    served, submitted = int(m.group(1)), int(m.group(2))
    balancer = [ln for ln in lines if ln.startswith("[gateway] balancer:")]
    if served != live["requests"] or \
            live["requests"] + live["dropped"] != submitted:
        raise AssertionError(f"gateway c: {live['requests']} served + "
                             f"{live['dropped']} dropped != {submitted}")
    if any(ln.startswith("[gateway] errors") for ln in lines):
        raise AssertionError("gateway c: invoke errors")
    measured = load_calibration(cal)          # raises on a bad document
    with open(cal) as f:
        meta = json.load(f)["meta"]
    compiles = meta["exe_cache"]["compiles"]
    after = check_warmed("c", meta["warm"], compiles)
    r = {"requests": live["requests"], "dropped": live["dropped"],
         "submitted": submitted, "cold_runtime": live["cold_runtime"],
         "pool_claims": live["pool_claims"], "transfers": live["transfers"],
         "p50_s": live["p50_s"], "p99_s": live["p99_s"],
         "p50_wall_ms": live["p50_s"] / 120 * 1e3,
         "p99_wall_ms": live["p99_s"] / 120 * 1e3,
         "request_overhead_ms": meta["request_overhead_ms"],
         "compiles": compiles, "compiles_after_warmup": after,
         "warm": meta["warm"],
         "calibration": measured,
         "calibration_wall_s": {k: (measured[f] / 120 if f in measured
                                    else None)
                                for k, f in CALIBRATION_COSTS.items()},
         "balancer": balancer[0] if balancer else None,
         "n_nodes": live["n_nodes"], "mean_mem_mb": live["mean_mem_mb"],
         "child_wall_s": wall}
    if not balancer:
        raise AssertionError("gateway c: no balancer stats printed")
    log_leg("c", r)
    return r


def phase_gateway(tmp: str) -> dict:
    """Phase 8 (module docstring)."""
    from repro_torch.gateway import load_trace
    trace = load_trace(AZURE)
    d = trace.describe()
    log(f"[gateway] trace: {d['invocations']} invocations, {d['functions']} "
        f"functions, {d['tenants']} tenants over {d['duration_s']:.0f} s")
    counters = zero_launches()              # this path's run starts here
    res = {"trace": d}
    t0 = time.perf_counter()
    res["a"] = validated_leg("a", trace, compress=60.0, pool_size=4,
                             mem_scale=1.0 / 64)
    res["a"]["traced_export"] = traced_export(tmp)
    res["a"]["leg_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    b = validated_leg("b", trace, compress=120.0, pool_size=4, mem_scale=1.0)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    # the initial pool of 4 plus every boot inside the replay window, each
    # with the simulator's 2 GiB runtime_cap as its budget
    boots = 4 + b["boots_in_window"]
    b.update(max_allocated_growth_bytes=growth, runtimes_booted=boots,
             budget_bound_bytes=boots * 2 * GiB,
             leg_s=time.perf_counter() - t0)
    log(f"[gateway b] max_memory_allocated grew {growth / 2**20:.1f} MiB "
        f"over the replay; {boots} runtimes booted x 2 GiB = "
        f"{boots * 2} GiB bound")
    if not 0 < growth <= boots * 2 * GiB:
        raise AssertionError(f"gateway b: device memory growth {growth} "
                             f"outside (0, {boots} x 2 GiB]")
    if b["n_errors"]:
        raise AssertionError(f"gateway b: invoke errors {b['errors']}")
    res["b"] = b
    t0 = time.perf_counter()
    res["c"] = cluster_leg(tmp)
    res["c"]["leg_s"] = time.perf_counter() - t0
    res["launches"] = check_launches("gateway", counters, ())
    log("[gateway] the four kernels' launches over the phase are expected "
        "to be 0: the gateway's emulated function is one affine program "
        "(leg c's child process keeps its own counters)")
    return res


SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:19"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:72"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:76"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:67"),
    # no Pallas backward exists: these replace the gradient that the
    # reference takes with jax.value_and_grad through the forward kernel's
    # jnp oracle
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                    "src/repro/kernels/rmsnorm.py:19"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:72"),
}
# the training phase's runs, each with its own launch counters
TRAIN_PATHS = ("qwen", "gemma3-1b", "granite-moe-1b-a400m", "drill")
ATTENTION = ("rmsnorm", "flash_attention", "decode_attention")
# arch -> (kernels its serving path must launch, batched requests,
#          how its logits are held to the plain path, decode profile,
#          layers it is cut to or None)
PATHS = {
    "qwen2.5-3b": (ATTENTION, 6, "direct", True, None),
    "zamba2-2.7b": (ATTENTION + ("ssd_scan",), 6, "fp32", True, None),
    "mamba2-780m": (("rmsnorm", "ssd_scan"), 4, None, False, None),
    "granite-moe-1b-a400m": (ATTENTION, 6, "fp32", True, None),
    "gemma3-1b": (ATTENTION, 6, "direct", False, None),
    # 28.5 GB of bf16 weights at 4 of its 40 layers
    "dbrx-132b": (ATTENTION, 6, "rms", False, 4),
}
# the families whose inputs hold embeddings: arch -> layers it is cut to
FRONTENDS = {"internvl2-76b": 8, "musicgen-large": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    log(nvidia_smi())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    REPORT["build_s"] = time.perf_counter() - t0
    REPORT["build_logs"] = dict(_build.BUILD_LOGS)
    log(f"[build] {sorted(libs)} in {REPORT['build_s']:.1f}s")
    for stem, text in sorted(_build.BUILD_LOGS.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {stem}] {line.strip()}")

    t0 = time.perf_counter()
    REPORT["kernels"] = phase_kernels()
    log(f"[kernels] phase done in {time.perf_counter() - t0:.1f}s")
    REPORT["paths"] = {}
    for arch, (kernels, n_batched, logits, profile, layers) in PATHS.items():
        t0 = time.perf_counter()
        REPORT["paths"][arch] = phase_lm_path(
            arch, kernels, n_batched, logits=logits, profile=profile,
            layers=layers)
        REPORT["paths"][arch]["path_s"] = time.perf_counter() - t0
        log(f"[{arch}] path done in {time.perf_counter() - t0:.1f}s")
    for arch, layers in FRONTENDS.items():
        t0 = time.perf_counter()
        REPORT["paths"][arch] = phase_frontend(arch, layers)
        REPORT["paths"][arch]["path_s"] = time.perf_counter() - t0
        log(f"[{arch}] path done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    REPORT["serve"] = phase_serve()
    log(f"[serve] phase done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()        # between phases, off any request path
    snap_root = tempfile.mkdtemp(prefix="hydra-chip-smoke-")
    try:
        t0 = time.perf_counter()
        REPORT["train"] = phase_train(snap_root)
        log(f"[train] phase done in {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        REPORT["platform"] = phase_platform(snap_root)
        log(f"[platform] phase done in {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(snap_root, "platform"))
        t0 = time.perf_counter()
        REPORT["cluster"] = phase_cluster(snap_root)
        log(f"[cluster] phase done in {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(snap_root, "cluster"))
        t0 = time.perf_counter()
        REPORT["gateway"] = phase_gateway(snap_root)
        log(f"[gateway] phase done in {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(snap_root, ignore_errors=True)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    REPORT["card"] = nvidia_smi()
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_report.json"),
              "w") as f:
        json.dump(REPORT, f, indent=1, default=str)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = REPORT["kernels"][name]
        by_path = {arch: p["launches"][name]
                   for arch, p in REPORT["paths"].items()}
        for path in ("platform", "cluster", "gateway"):
            by_path[path] = REPORT[path]["launches"][name]
        for run in TRAIN_PATHS:
            by_path[f"train {run}"] = REPORT["train"][run]["launches"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            **({"backward_of": name[:-4]} if name.endswith("_bwd") else {}),
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            **{k: r[k] for k in ("device_ms", "plain_device_ms",
                                 "library_device_ms", "ctas", "splits",
                                 "ptxas") if k in r}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--restore-child"]:
        sys.exit(restore_child(sys.argv[2], float(sys.argv[3])))
    sys.exit(main())
