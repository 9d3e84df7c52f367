"""Prefill flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and
its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_kernel``): forward blocked attention with GQA
(query head h reads KV head ``h // group``), a causal mask, an optional
sliding window ``kpos > qpos - window``, fp32 online softmax and
``acc / max(l, 1e-30)``.

Bound on the H100: operations at long prompts, bytes at short ones. bf16
runs on the tensor cores: one CTA per (64-query tile, head, row), a
warpgroup issuing ``wgmma`` for Q K^T and P V, and a producer warp
streaming 64-key K/V tiles through TMA into a 2-stage ring. fp32 keeps
the scalar-FMA kernel (``wgmma`` on fp32 is TF32, which misses the fp32
tolerance); a bf16 layout TMA cannot address (a base or a stride that is
not a multiple of 16 bytes) raises. Both visit only the KV tiles
a query tile can see (tiles above the causal diagonal or before the
window are skipped, where the Pallas grid visits every block), and both
read the (B, S, H, hd) layout through strides, so the wrapper makes no
transposed copies.

The window is a Python int applied literally, with no overflow in the
index arithmetic, so ``GLOBAL_WINDOW`` gives the same result as None.

The plain version is ``kernels/ref.py:flash_attention_ref``; the wrapper
takes it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)
_LL = ctypes.c_longlong
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [_LL] * 12
             + [ctypes.c_float, ctypes.c_int, _LL, ctypes.c_int,
                ctypes.c_void_p])
_count_lock = threading.Lock()


def check_window(window) -> int:
    """Static window as the kernels take it: 0 = none, else an int >= 1."""
    if window is None:
        return 0
    if isinstance(window, bool) or not isinstance(window, int):
        raise TypeError(f"window must be a Python int or None, got "
                        f"{type(window).__name__}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return window


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B,S,Hq,hd), k/v (B,S,Hkv,hd) -> (B,S,Hq,hd)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if not q.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must share one CUDA device")
    if q.dtype not in _build.DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; need one of fp32/bf16 for all three")
    if tuple(k.shape) != (B, S, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} not a multiple of "
                         f"Hkv={Hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 tensors need 16-byte aligned "
                         "bases and strides (the kernel loads them by TMA)")
    win = check_window(window)
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device)
    fn = _build.kernel("flash_attention", "hydra_flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, S, Hq, Hkv, hd, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], *out.stride()[:3], scale, int(causal), win,
             _build.DTYPES[q.dtype],
             _build.stream(q))
    _build.check(err, "flash_attention")
    with _count_lock:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0      # kernel launches since the last reset
