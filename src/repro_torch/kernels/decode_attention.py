"""Decode attention: the CUDA kernel ``csrc/decode_attention.cu`` and its
wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention`` / ``_kernel``): one query token per row, q
(B,Hq,hd), against a KV cache (B,S,Hkv,hd) with a valid length per row
and an optional window mask ``kpos > length - 1 - window``.

Bound on the H100: bytes (each visible K/V row is read once, at 2*group
flops per element). The kernel gives one block to the ``group`` query
heads of each KV head, so a K/V row is read once for all of them, reads
the row's length from device memory (no host sync), and visits only the
keys ``[max(0, length - window), min(length, S))`` that row can see.

Edge semantics follow the oracle, not the Pallas kernel: ``length > S``
attends all S keys with the window taken from the unclamped length, and a
row with no visible key (``length == 0``) gets the uniform mean of V over
all S rows, where the Pallas kernel returns 0.

The plain version is ``kernels/ref.py:decode_attention_ref``; the wrapper
takes it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check_window
from repro_torch.kernels.ref import decode_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_GROUP = 16             # query heads per KV head in one block
_LL = ctypes.c_longlong
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [_LL] * 10
             + [ctypes.c_float, _LL, ctypes.c_int, ctypes.c_void_p])
_count_lock = threading.Lock()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """q (B,Hq,hd), k/v cache (B,S,Hkv,hd), lengths (B,) -> (B,Hq,hd)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths,
                                    window=window, scale=scale)
    B, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    tensors = (q, k_cache, v_cache, lengths)
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: all inputs must share one CUDA "
                         "device")
    if q.dtype not in _build.DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,) \
            or not lengths.is_contiguous():
        raise ValueError("decode_attention: lengths must be a contiguous "
                         f"int32 ({B},) tensor")
    if tuple(k_cache.shape) != (B, S, Hkv, hd) \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if Hkv == 0 or Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: Hq={Hq}, Hkv={Hkv} (group must "
                         f"divide evenly and be <= {MAX_GROUP})")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    # the kernel reads each key row as 16-byte vectors
    vec = 16 // q.element_size()
    for t in (k_cache, v_cache):
        if t.stride(-1) != 1 or t.data_ptr() % 16 \
                or any(s % vec for s in t.stride()[:3]):
            raise ValueError("decode_attention: caches need a contiguous, "
                             "16-byte aligned head dim")
    if q.stride(-1) != 1:
        raise ValueError("decode_attention: q's head dim must be contiguous")
    win = check_window(window)
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    fn = _build.kernel("decode_attention", "hydra_decode_attention",
                       _ARGTYPES)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, hd,
             *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
             *out.stride()[:2], scale, win, _build.DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    with _count_lock:
        decode_attention.launches += 1
    return out


decode_attention.launches = 0     # kernel launches since the last reset
