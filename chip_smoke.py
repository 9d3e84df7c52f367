#!/usr/bin/env python3
"""On-card smoke test of repro_torch, the PyTorch/CUDA port of Hydra.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc/`` (one nvcc per source, all started together) and then runs five
phases; any failure exits non-zero.

1. Each kernel against its plain PyTorch version on the card, in bf16 and
   fp32, at the full-width shapes of the serving paths plus edge cases,
   with the tolerances of tests/test_kernels.py (fp32 2e-5, bf16 5e-2,
   the SSD final state 1e-3): rmsnorm at the three paths' widths, odd
   widths and unaligned rows; flash and decode attention at
   qwen2.5-3b's, zamba2-2.7b's (head dim 80) and gemma3-1b's (head dim
   256, 4 q / 1 KV head, window 512) shapes, ragged S, a window, deep
   GQA, decode lengths 0, 1 and > S, lengths that end inside a split and
   windows that leave most splits empty; ssd_scan at zamba2's
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
   kernels' registers and spills from the ptxas report.
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
5. The reduced closed-loop serve, ``repro_torch.launch.serve``, over one
   tenant each of qwen2.5-3b, mamba2-780m and zamba2-2.7b.

Each serving path sets the launch counters to 0 just before its runtime
run and reads them just after.

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
import subprocess
import sys
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
                  (13, 2048)]:
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
             (2, 200, *GEMMA3, True, None)]
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
              (2, 1024, *GEMMA3, None, [144, 516])]
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
    out["ssd_scan"] = phase_ssd(gen)
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
                         ("qwen prefill", (1, 500, QWEN["D"]))]:
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
        nv = next(v for v in (2, 4, 8, 12, 16) if 32 * 8 * v >= D)
        rows[label] = dict(
            shape=list(shape), max_abs_err=err, ctas=-(-n // 8),
            warps=n, ptxas=ptxas_usage("rmsnorm", "rmsnorm_kernel",
                                       "13__nv_bfloat16S1_", f"Li{nv}E"),
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
    if not cfg.tie_embeddings:
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


def logits_fp32(prog, params, prompt, arch) -> dict:
    """Kernel path against plain path for a deep bf16 model, where bf16
    rounding noise (one-ulp flips of the SSD output, fp32 vs bf16 softmax
    probabilities) compounds over 63 blocks and an elementwise check on
    logits measures that noise: the kernel path's logits must lie within
    5e-2 of the plain path's in relative RMS, and be at least as close as
    the plain path's (up to 1.25x) to an fp32 run of the same weights
    through the plain versions. The elementwise max difference is
    reported."""
    import dataclasses

    from repro_torch.models.programs import ModelProgram

    (pre_k, pre_r), (dec_k, dec_r), nxt = first_logits(prog, params, prompt)
    prog32 = ModelProgram(dataclasses.replace(prog.cfg, dtype="float32"))
    cast = lambda t: {k: cast(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.float()
    p32 = cast(params)
    with torch.no_grad(), plain_path():
        toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
        pre_t, cache_t = prog32.prefill(p32, {"tokens": toks})
        dec_t, _ = prog32.decode_step(p32, grow_cache(cache_t, 32),
                                      {"tokens": nxt})
    del p32, cache_t
    out = {}
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


def phase_lm_path(arch: str, kernels: tuple, n_batched: int, *,
                  logits: str | None, profile: bool) -> dict:
    """One architecture's serving path at full width, from the port's
    seeded bf16 init: optionally the prefill and first decode logits,
    kernel path against plain path (``logits``: "direct" or "fp32", see
    logits_direct and logits_fp32); then register (slots 4, max_seq
    1024), one ``generate`` per prompt (128 and 500 tokens, 32 new), and
    ``n_batched`` requests through one ``ContinuousBatcher``, whose tokens
    must equal the single-path tokens. The launch counters are set to 0
    just before the runtime run and read just after; each of ``kernels``
    must have moved."""
    from repro_torch.configs import get_config
    from repro_torch.core import ContinuousBatcher, HydraRuntime, LMSpec
    from repro_torch.core.arena import tree_bytes
    from repro_torch.models.programs import ModelProgram

    cfg = get_config(arch)
    tag = f"[{arch}]"
    prog = ModelProgram(cfg)
    t0 = time.perf_counter()
    params = prog.init(0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = tree_bytes(params)
    log(f"{tag} {cfg.family}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {param_bytes / 1e9:.3f} GB of bf16 weights "
        f"drawn in {init_s:.1f}s")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (128, 500)]
    res = dict(arch=cfg.name, family=cfg.family, init_s=init_s,
               param_bytes=param_bytes)
    if logits == "direct":
        res.update(logits_direct(prog, params, prompts[0], arch))
    elif logits == "fp32":
        res.update(logits_fp32(prog, params, prompts[0], arch))
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
    rt = HydraRuntime(device="cuda", memory_budget_bytes=16 << 30)
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
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "decode_attention": decode_attention, "ssd_scan": ssd_scan}


# ---------------------------------------------------------------------------
# phase 5: the reduced closed-loop serve
# ---------------------------------------------------------------------------
def phase_serve() -> dict:
    from repro_torch.launch import serve
    s = serve.main(["--pool", "0", "--archs",
                    "qwen2.5-3b,mamba2-780m,zamba2-2.7b", "--tenants", "3",
                    "--requests", "9"])
    if s["tokens"] <= 0:
        raise AssertionError("serve produced no tokens")
    return {k: s[k] for k in ("requests", "tokens", "wall_s")}


SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:19"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:72"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:76"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:67"),
}
ATTENTION = ("rmsnorm", "flash_attention", "decode_attention")
# arch -> (kernels its serving path must launch, batched requests,
#          how its logits are held to the plain path, decode profile)
PATHS = {
    "qwen2.5-3b": (ATTENTION, 6, "direct", True),
    "zamba2-2.7b": (ATTENTION + ("ssd_scan",), 6, "fp32", True),
    "mamba2-780m": (("rmsnorm", "ssd_scan"), 4, None, False),
}


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

    REPORT["kernels"] = phase_kernels()
    REPORT["paths"] = {}
    for arch, (kernels, n_batched, logits, profile) in PATHS.items():
        t0 = time.perf_counter()
        REPORT["paths"][arch] = phase_lm_path(
            arch, kernels, n_batched, logits=logits, profile=profile)
        log(f"[{arch}] path done in {time.perf_counter() - t0:.1f}s")
    REPORT["serve"] = phase_serve()

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
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
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
    sys.exit(main())
