#!/usr/bin/env python3
"""Device times of two checkouts' rmsnorm, ssd_scan, rmsnorm_bwd,
ssd_scan_bwd and flash_attention_bwd kernels on one card, in turns, so
that a redesign is compared with the design before it in the same run.

    python3 chip_ab.py OTHER_CHECKOUT

Each turn is a process of its own that imports ``repro_torch`` from one
checkout, builds that checkout's kernels (into its own
``src/repro_torch/kernels/build/``) and times its public wrappers at
chip_smoke.py's serving shapes, on the same seeded inputs: rmsnorm (bf16)
at the decode rows of qwen2.5-3b, zamba2-2.7b and mamba2-780m and at a
500-token prompt, beside ``F.rms_norm``; ssd_scan (bf16, chunk 256, final
state) at zamba2-2.7b's and mamba2-780m's 500-token prefill;
rmsnorm_bwd (bf16 x and dy, fp32 w) at the training rows (8,128,2048),
beside ``F.rms_norm``'s backward; ssd_scan_bwd (bf16, chunk 128, the
column-slice layout, from the forward's saved a_cs and states) at
zamba2-2.7b's and mamba2-780m's training shapes (8,128,80,64) N 64 and
(8,128,48,64) N 128, beside autograd of the plain version (no PyTorch
call computes the SSD backward) and the bound; flash_attention_bwd
(bf16, causal) at
qwen2.5-3b's training shape (8,128,16,128) / KV 2, a 500-token prompt,
granite-moe's hd 64 group 2 (8,128,16,64) / KV 8 and gemma3-1b's hd 256
window 512 (1,1024,4,256) / KV 1, beside SDPA's backward (autograd over a
kept graph, as chip_smoke.py times it). Each time is the torch.profiler
device time of one call (chip_smoke.device_ms), and for rmsnorm and the
backward kernels also the CUDA-events time per call over back-to-back
calls.
The turns run other, this, this, other, so a drift of the card between
them shows. Output: the card's name and power limit, then one JSON object
with every turn; the same goes to ``chiprun_out/chip_ab.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def worker(checkout: str) -> dict:
    import chip_smoke as cs                    # puts ROOT/src on the path
    sys.path.insert(0, os.path.join(os.path.abspath(checkout), "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    out = {"checkout": os.path.abspath(checkout), "rmsnorm": {},
           "ssd_scan": {}}
    for shape in [(4, 1, cs.QWEN["D"]), (4, 1, cs.ZAMBA["D"]),
                  (4, 1, cs.MAMBA["D"]), (1, 500, cs.QWEN["D"])]:
        D = shape[-1]
        x = cs.randn(shape, bf16, gen)
        w = (cs.randn((D,), torch.float32, gen) * 0.1).to(bf16)
        w1 = (1.0 + w.float()).to(bf16)
        kern = lambda: rmsnorm(x, w)
        lib = lambda: F.rms_norm(x, (D,), w1, 1e-5)
        out["rmsnorm"][str(shape)] = dict(
            device_ms=cs.device_ms(kern), library_device_ms=cs.device_ms(lib),
            events_ms=cs.cuda_ms(kern, iters=300),
            library_events_ms=cs.cuda_ms(lib, iters=300))
    for name, m in (("zamba2", cs.ZAMBA), ("mamba2", cs.MAMBA)):
        args = cs.ssd_inputs(gen, 1, 500, m["H"], m["P"], m["N"], bf16,
                             strided=True)
        out["ssd_scan"][name] = dict(
            shape=[1, 500, m["H"], m["P"]], N=m["N"],
            device_ms=cs.device_ms(lambda: ssd_scan(
                *args, chunk=cs.SSD_CHUNK, return_state=True)))
    out.update(backward_times(cs, gen))
    return out


def backward_times(cs, gen) -> dict:
    """rmsnorm_bwd, ssd_scan_bwd and flash_attention_bwd of the checkout on
    the path first, and their library calls' backward (ssd_scan_bwd: the
    plain version's, as no library call computes it), at the training
    shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    from repro_torch.kernels.ssd_scan import _forward as ssd_forward
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd

    bf16, f32 = torch.bfloat16, torch.float32
    out = {"rmsnorm_bwd": {}, "ssd_scan_bwd": {}, "flash_attention_bwd": {}}
    D = cs.QWEN["D"]
    shape = (cs.TRAIN_B, cs.TRAIN_S, D)
    x, dy = cs.randn(shape, bf16, gen), cs.randn(shape, bf16, gen)
    w = cs.randn((D,), f32, gen) * 0.1
    xl = x.clone().requires_grad_()
    wl = (1.0 + w).to(bf16).requires_grad_()
    yl = F.rms_norm(xl, (D,), wl, 1e-5)
    kern = lambda: rmsnorm_bwd(dy, x, w)
    lib = lambda: torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True)
    out["rmsnorm_bwd"][str(shape)] = dict(
        device_ms=cs.device_ms(kern), library_device_ms=cs.device_ms(lib),
        events_ms=cs.cuda_ms(kern, iters=100))
    B, S = cs.TRAIN_B, cs.TRAIN_S
    for name, m in (("zamba2", cs.ZAMBA), ("mamba2", cs.MAMBA)):
        H, P, N = m["H"], m["P"], m["N"]
        x, dt, A, Bm, Cm = cs.ssd_inputs(gen, B, S, H, P, N, bf16,
                                         strided=True)
        dy = cs.randn((B, S, H, P), bf16, gen)
        saved = ssd_forward(x, dt, A, Bm, Cm, S, None, False, save=True)[2]
        kern = lambda: ssd_scan_bwd(dy, x, dt, A, Bm, Cm, chunk=S,
                                    saved=saved)
        ins = [t.detach().clone().requires_grad_()
               for t in (x, dt, A, Bm, Cm)]
        yp = ref.ssd_scan_ref(*ins, chunk=S)
        plain = lambda: torch.autograd.grad(yp, ins, dy, retain_graph=True)
        out["ssd_scan_bwd"][name] = dict(
            shape=[B, S, H, P], N=N, chunk=S,
            bound_ms=cs.ssd_bwd_bound(B, S, H, P, N, S, bf16)[0],
            device_ms=cs.device_ms(kern), plain_device_ms=cs.device_ms(plain),
            events_ms=cs.cuda_ms(kern, iters=50))
    H, K, hd = cs.QWEN["Hq"], cs.QWEN["Hkv"], cs.QWEN["hd"]
    for label, (B, S, hq, hkv, d, win) in {
            "qwen training": (cs.TRAIN_B, cs.TRAIN_S, H, K, hd, None),
            "500-token prompt": (1, 500, H, K, hd, None),
            "granite-moe hd64 group 2": (cs.TRAIN_B, cs.TRAIN_S,
                                         *cs.GRANITE_MOE, None),
            "gemma3 hd256 window 512": (1, 1024, *cs.GEMMA3,
                                        cs.GEMMA3_WINDOW)}.items():
        q, dout = (cs.randn((B, S, hq, d), bf16, gen) for _ in range(2))
        k, v = (cs.randn((B, S, hkv, d), bf16, gen) for _ in range(2))
        lse = torch.empty((B, hq, S), dtype=f32, device="cuda")
        o = _forward(q, k, v, True, win, None, lse)
        kern = lambda: flash_attention_bwd(q, k, v, o, lse, dout, window=win)
        lib_in = [t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v)]
        if win is None:
            ol = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                                enable_gqa=True)
        else:
            pos = torch.arange(S, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - win)
            ol = F.scaled_dot_product_attention(*lib_in, attn_mask=mask,
                                                enable_gqa=True)
        dlib = dout.transpose(1, 2).contiguous()
        lib = lambda: torch.autograd.grad(ol, lib_in, dlib,
                                          retain_graph=True)
        out["flash_attention_bwd"][label] = dict(
            shape=[B, S, hq, d], kv_heads=hkv, window=win,
            device_ms=cs.device_ms(kern), library_device_ms=cs.device_ms(lib),
            events_ms=cs.cuda_ms(kern, iters=50))
    return out


def main(argv: list) -> int:
    if len(argv) == 2 and argv[0] == "--worker":
        print(json.dumps(worker(argv[1])))
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device visible", file=sys.stderr)
        return 1
    card = cs.nvidia_smi()
    print(card, flush=True)
    turns = []
    for tag, checkout in (("other", argv[0]), ("this", ROOT), ("this", ROOT),
                          ("other", argv[0])):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", checkout], capture_output=True,
                             text=True, timeout=900)
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append(dict(turn=tag, **json.loads(
            res.stdout.strip().splitlines()[-1])))
        print(json.dumps(turns[-1]), flush=True)
    report = {"card": card, "turns": turns}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_ab.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
