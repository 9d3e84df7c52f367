#!/usr/bin/env python3
"""On-card smoke test of repro_torch, the PyTorch/CUDA port of Hydra.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc/`` and then runs three phases; any failure exits non-zero.

1. Each kernel against its plain PyTorch version on the card, in bf16 and
   fp32, at the full-width qwen2.5-3b shapes of the serving path plus edge
   cases (ragged S, a window, deep GQA, decode lengths 0, 1 and > S), with
   the tolerances of tests/test_kernels.py (fp32 2e-5, bf16 5e-2). It
   times each kernel, its plain version and one PyTorch library call for
   the same function (never called by the port) as a yardstick.
2. The main path at full width: the port's seeded init of the unreduced
   qwen2.5-3b (36 layers, bf16) registered in a ``HydraRuntime`` (slots
   4, max_seq 1024), one ``generate`` per prompt, then six requests
   through one ``ContinuousBatcher``. Batched tokens must equal the
   single-path tokens, every kernel's launch counter must move, and the
   first decode logits must match the plain path on the card.
3. The reduced closed-loop serve, ``repro_torch.launch.serve``.

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
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models.attention import GLOBAL_WINDOW

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}

    # ---- rmsnorm: decode rows (4 slots), a 500-token prompt, small rows
    for shape in [(4, 1, QWEN["D"]), (1, 500, QWEN["D"]), (3, 17, 64)]:
        for xd, wd in [(f32, f32), (bf16, bf16), (bf16, f32)]:
            x = randn(shape, xd, gen)
            w = (randn(shape[-1:], f32, gen) * 0.1).to(wd)
            compare(f"rmsnorm {shape} x={xd} w={wd}", rmsnorm(x, w),
                    ref.rmsnorm_ref(x, w), xd)
    x = randn((4, 1, QWEN["D"]), bf16, gen)
    w = (randn((QWEN["D"],), f32, gen) * 0.1).to(bf16)
    err = compare("rmsnorm main-path decode rows", rmsnorm(x, w),
                  ref.rmsnorm_ref(x, w), bf16)
    w1 = (1.0 + w.float()).to(bf16)
    nbytes = 2 * x.numel() * 2 + w.numel() * 2
    b_ms, b_by = bound(nbytes, 4.0 * x.numel(), bf16)
    xp = randn((1, 500, QWEN["D"]), bf16, gen)
    out["rmsnorm"] = dict(
        shape=list(x.shape), max_abs_err=err,
        ms=cuda_ms(lambda: rmsnorm(x, w)),
        plain_ms=cuda_ms(lambda: ref.rmsnorm_ref(x, w)),
        library_ms=cuda_ms(lambda: F.rms_norm(x, (QWEN["D"],), w1, 1e-5)),
        bound_ms=b_ms, bound_by=b_by,
        prefill_shape=list(xp.shape),
        prefill_ms=cuda_ms(lambda: rmsnorm(xp, w)),
        prefill_plain_ms=cuda_ms(lambda: ref.rmsnorm_ref(xp, w)),
        prefill_bound_ms=bound(2 * xp.numel() * 2 + w.numel() * 2,
                               4.0 * xp.numel(), bf16)[0])

    # ---- flash attention: the main path's prefill shape, plus the sweep
    H, K, hd = QWEN["Hq"], QWEN["Hkv"], QWEN["hd"]
    cases = [(1, 500, H, K, hd, True, None), (1, 128, H, K, hd, True, None),
             (1, 500, H, K, hd, True, 64),
             (2, 128, 4, 2, 64, True, None), (1, 256, 4, 1, 32, True, 64),
             (2, 100, 8, 8, 16, True, None), (1, 64, 4, 4, 128, False, None),
             (1, 64, 16, 2, 8, True, 16)]
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
    q = randn((1, S, H, hd), bf16, gen)
    k = randn((1, S, K, hd), bf16, gen)
    v = randn((1, S, K, hd), bf16, gen)
    err = compare("flash main-path prefill", flash_attention(
        q, k, v, window=GLOBAL_WINDOW), ref.flash_attention_ref(q, k, v), bf16)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    flops = 4.0 * hd * H * S * (S + 1) / 2       # causal QK^T and PV
    b_ms, b_by = bound(nbytes, flops, bf16)
    out["flash_attention"] = dict(
        shape=list(q.shape), kv_heads=K, max_abs_err=err,
        ms=cuda_ms(lambda: flash_attention(q, k, v, window=GLOBAL_WINDOW)),
        plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by)

    # ---- decode attention: 4 slots over a 1024-row cache, plus edges
    dcases = [(4, 1024, H, K, hd, None, [0, 1, 700, 1500]),
              (4, 1024, H, K, hd, 256, [0, 1, 700, 1500]),
              (4, 1024, H, K, hd, 256, [1100, 1300, 5, 1024]),
              (2, 256, 4, 2, 64, None, None), (3, 100, 8, 1, 32, None, None),
              (2, 512, 4, 4, 128, 128, None), (1, 64, 16, 2, 16, None, None)]
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
    # main-path shape: the 36 layer slices of one slab, so each launch
    # finds its cache cold in L2 as a decode step does
    L, B, S = 36, 4, 1024
    q = randn((B, H, hd), bf16, gen)
    kc = randn((L, B, S, K, hd), bf16, gen)
    vc = randn((L, B, S, K, hd), bf16, gen)
    lengths = torch.tensor([144, 516, 144, 516], dtype=torch.int32,
                           device="cuda")
    err = compare("decode main-path step", decode_attention(
        q, kc[0], vc[0], lengths, window=GLOBAL_WINDOW),
        ref.decode_attention_ref(q, kc[0], vc[0], lengths), bf16)
    it = iter(range(10 ** 9))
    layer = lambda: next(it) % L
    kt = kc.transpose(2, 3).contiguous()          # (L, B, Hkv, S, hd)
    vt = vc.transpose(2, 3).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    visible = int(lengths.clamp(max=S).sum())
    nbytes = (2 * visible * K * hd + 2 * q.numel()) * 2 + lengths.numel() * 4
    b_ms, b_by = bound(nbytes, 4.0 * hd * H * visible, bf16)

    def lib():
        i = layer()
        return F.scaled_dot_product_attention(
            q[:, :, None], kt[i], vt[i], attn_mask=mask, enable_gqa=True)

    def kern():
        i = layer()
        return decode_attention(q, kc[i], vc[i], lengths,
                                window=GLOBAL_WINDOW)

    def plain():
        i = layer()
        return ref.decode_attention_ref(q, kc[i], vc[i], lengths)

    out["decode_attention"] = dict(
        shape=[B, S, K, hd], lengths=lengths.tolist(), max_abs_err=err,
        ms=cuda_ms(kern, iters=72), plain_ms=cuda_ms(plain, iters=72),
        library_ms=cuda_ms(lib, iters=72), bound_ms=b_ms, bound_by=b_by)
    for name, r in out.items():
        log(f"[kernels] {name} @ {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return out


# ---------------------------------------------------------------------------
# phase 2: the main path at full width
# ---------------------------------------------------------------------------
def phase_main_path() -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import ContinuousBatcher, HydraRuntime, LMSpec
    from repro_torch.core.arena import tree_bytes
    from repro_torch.kernels import ops
    from repro_torch.models.programs import ModelProgram

    cfg = get_config("qwen2.5-3b")
    prog = ModelProgram(cfg)
    t0 = time.perf_counter()
    params = prog.init(0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = tree_bytes(params)
    log(f"[main] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {param_bytes / 1e9:.3f} GB of bf16 weights "
        f"drawn in {init_s:.1f}s")

    # the first decode logits: kernel path vs plain path, same cache
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (128, 500)]
    with torch.no_grad():
        toks = torch.tensor([prompts[0]], dtype=torch.int32, device="cuda")
        pre_k, cache = prog.prefill(params, {"tokens": toks})
        ops.set_kernel_mode("ref")
        try:
            pre_r, _ = prog.prefill(params, {"tokens": toks})
        finally:
            ops.set_kernel_mode(None)
        grow = lambda t: torch.cat([t, torch.zeros_like(t[:, :, :32])], 2)
        nxt = torch.argmax(pre_r, -1).to(torch.int32)[:, None]
        cache_k = {"k": grow(cache["k"]), "v": grow(cache["v"]),
                   "length": cache["length"].clone()}
        cache_r = {k: v.clone() for k, v in cache_k.items()}
        dec_k, _ = prog.decode_step(params, cache_k, {"tokens": nxt})
        ops.set_kernel_mode("ref")
        try:
            dec_r, _ = prog.decode_step(params, cache_r, {"tokens": nxt})
        finally:
            ops.set_kernel_mode(None)
    # prefill runs 36 layers of 128-token bf16 attention whose softmax
    # probabilities the kernel keeps in fp32 and the plain version rounds
    # to bf16; the difference compounds through the residual stream, so
    # this check takes twice the bf16 tolerance
    prefill_err = compare("main path prefill logits kernel vs plain", pre_k,
                          pre_r, torch.bfloat16, tol=2 * TOL[torch.bfloat16])
    decode_err = compare("main path first decode logits kernel vs plain",
                         dec_k, dec_r, torch.bfloat16)
    del cache, cache_k, cache_r
    prefill_ms = {}
    with torch.no_grad():
        for p in prompts:
            t = torch.tensor([p], dtype=torch.int32, device="cuda")
            prefill_ms[len(p)] = host_ms(lambda: prog.prefill(
                params, {"tokens": t}), iters=3)
    log(f"[main] prefill ms by prompt length: {prefill_ms}")

    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0                     # the main path's run starts here
    rt = HydraRuntime(device="cuda", memory_budget_bytes=16 << 30)
    try:
        t0 = time.perf_counter()
        spec = LMSpec(cfg=cfg, params=params, max_seq=1024, slots=4)
        rt.register_function("qwen", spec)
        register_s = time.perf_counter() - t0
        single = [rt.generate("qwen", p, max_new_tokens=32) for p in prompts]
        b = ContinuousBatcher(rt, "qwen")
        try:
            futs = [b.submit(prompts[i % 2], 32) for i in range(6)]
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
        b = ContinuousBatcher(rt, "qwen")
        try:
            for _ in range(4):
                b.submit(prompts[0], 24)
            b.step()                        # admits all four slots
            profile = profile_decode(b, steps=8)
            b.run_until_done()
        finally:
            b.close()
        exe = rt.exe_cache.stats()
        arena = rt.arena_pool.stats()
    finally:
        rt.shutdown()

    for i, o in enumerate(outs):
        if o != single[i % 2]:
            raise AssertionError(f"batched request {i} tokens {o} != "
                                 f"single-path {single[i % 2]}")
    log(f"[main] batched tokens equal single-path tokens for all "
        f"{len(outs)} requests (prompt lengths 128/500, 32 new tokens)")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 f"main path")
    log(f"[main] kernel launches on the main path: {launches}")

    # a decode step must read every weight except the embedding table (it
    # gathers 4 rows) plus the visible KV rows
    embed = params["embed"]["tok"]
    step_bytes = param_bytes - embed.numel() * embed.element_size()
    kv_row = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    med = float(np.median(step_ms))
    toks_total = sum(len(o) for o in outs)
    res = dict(
        arch=cfg.name, init_s=init_s, register_s=register_s,
        param_bytes=param_bytes, exe_cache=exe, arena=arena,
        prefill_logits_err=prefill_err, decode_logits_err=decode_err,
        launches=launches, prefill_ms=prefill_ms, decode_profile=profile,
        tokens=toks_total, wall_s=wall_s,
        tok_s=toks_total / wall_s, decode_steps=len(step_ms),
        decode_step_ms_median=med, decode_step_ms_min=min(step_ms),
        decode_tok_s=decode_tokens / (sum(step_ms) / 1e3),
        step_weight_bytes=step_bytes,
        step_bound_ms=step_bytes / PEAK_BYTES_S * 1e3,
        kv_bytes_per_token=kv_row)
    log(f"[main] registration {register_s * 1e3:.1f} ms; {toks_total} tokens "
        f"in {wall_s:.2f}s = {res['tok_s']:.1f} tok/s through the batcher; "
        f"decode step median {med:.2f} ms (min {min(step_ms):.2f}) beside "
        f"its weight-read bound {res['step_bound_ms']:.2f} ms "
        f"({step_bytes / 1e9:.2f} GB / 3.35 TB/s); decode-only "
        f"{res['decode_tok_s']:.1f} tok/s")
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


def profile_decode(batcher, steps: int) -> dict:
    """Where a full-width decode step's time goes: torch.profiler over
    ``steps`` batcher steps (4 active slots), device kernel time by
    class, the device's busy share of the wall time, kernels per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            batcher.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name, n = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / steps
            n += 1
    classes = {"rmsnorm": "rmsnorm_kernel", "flash_attention": "flash_fwd",
               "decode_attention": "decode_kernel"}
    by_class = {c: 0.0 for c in list(classes) + ["gemm", "other"]}
    for name, ms in by_name.items():
        cls = next((c for c, key in classes.items() if key in name), None)
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
    log(f"[profile] decode step under the profiler: {wall_ms:.2f} ms wall, "
        f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{n / steps:.0f} kernels/step; by class (ms/step) "
        f"{ {k: round(v, 3) for k, v in by_class.items()} }")
    return res


def _kernel_counters() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "decode_attention": decode_attention}


# ---------------------------------------------------------------------------
# phase 3: the reduced closed-loop serve
# ---------------------------------------------------------------------------
def phase_serve() -> dict:
    from repro_torch.launch import serve
    s = serve.main(["--pool", "0", "--tenants", "2", "--requests", "8"])
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
    REPORT["main_path"] = phase_main_path()
    REPORT["serve"] = phase_serve()

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    REPORT["card"] = nvidia_smi()
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_report.json"),
              "w") as f:
        json.dump(REPORT, f, indent=1, default=str)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = REPORT["kernels"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=REPORT["main_path"]["launches"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
