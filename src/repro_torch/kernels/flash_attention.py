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

Training: ``FlashAttentionFn`` (a ``torch.autograd.Function``, taken by
``kernels/ops`` for CUDA tensors under autograd) runs the same forward
kernel with its optional log-sum-exp output and the hand-written
backward ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``: dq,
dk, dv; head dims ``BWD_HEAD_DIMS``), which has no TPU counterpart: the
reference differentiates the jnp oracle. Its bf16 path is built like the
forward (``wgmma`` fed by a TMA ring): a dq pass, then a dk/dv pass in
thread block clusters of one KV head's group, which sums the group's dK
and dV through distributed shared memory in head order (deterministic,
no fp32 partials in device memory); a group above ``MAX_BWD_GROUP``
raises.

The plain versions are ``kernels/ref.py:flash_attention_ref`` and
``flash_attention_bwd_ref``; the wrappers take them only for tensors that
lie on the CPU.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 80, 128, 224, 256)
BWD_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
MAX_BWD_GROUP = 8      # the portable thread block cluster size
_LL = ctypes.c_longlong
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [_LL] * 12
             + [ctypes.c_float, ctypes.c_int, _LL, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                 + [ctypes.POINTER(_LL), ctypes.c_float, ctypes.c_int, _LL,
                    ctypes.c_int, ctypes.c_void_p])
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


def _check(q, k, v, what: str, head_dims: tuple) -> None:
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if not q.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q, k, v must share one CUDA device")
    if q.dtype not in _build.DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what}: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; need one of fp32/bf16 for all three")
    if tuple(k.shape) != (B, S, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{what}: Hq={Hq} not a multiple of Hkv={Hkv}")
    if hd not in head_dims:
        raise ValueError(f"{what}: head dim {hd} not in {head_dims}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{what}: the head dim must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError(f"{what}: bf16 tensors need 16-byte aligned bases "
                         f"and strides (the kernels load them by TMA or "
                         f"cp.async)")


def _check_group(q, k) -> None:
    """The bf16 backward sums a KV head's group in one cluster of CTAs."""
    group = q.shape[2] // k.shape[2]
    if q.dtype == torch.bfloat16 and group > MAX_BWD_GROUP:
        raise ValueError(f"flash_attention_bwd: a GQA group of {group} q "
                         f"heads per KV head; the bf16 kernel sums a group "
                         f"in one thread block cluster, at most "
                         f"{MAX_BWD_GROUP}")


def _forward(q, k, v, causal, window, scale, lse) -> torch.Tensor:
    """One launch of the forward kernel; ``lse`` a (B,Hq,S) fp32 tensor
    to receive each row's log-sum-exp, or None."""
    B, S, Hq, hd = q.shape
    win = check_window(window)
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device)
    fn = _build.kernel("flash_attention", "hydra_flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, S, Hq, k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], *out.stride()[:3], scale, int(causal), win,
             _build.DTYPES[q.dtype], None if lse is None else lse.data_ptr(),
             _build.stream(q))
    _build.check(err, "flash_attention")
    with _count_lock:
        flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B,S,Hq,hd), k/v (B,S,Hkv,hd) -> (B,S,Hq,hd)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    _check(q, k, v, "flash_attention", HEAD_DIMS)
    return _forward(q, k, v, causal, window, scale, None)


flash_attention.launches = 0      # kernel launches since the last reset


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None) -> tuple:
    """(dq, dk, dv) in q's dtype for the output grad ``dout``, from the
    forward's ``out`` and its (B,Hq,S) fp32 ``lse``. bf16: two launches
    (the dq pass, which also writes the row sums D and q*scale; the dk/dv
    pass in clusters of ``group`` CTAs that sum each KV head's group in
    distributed shared memory), so a group above 8 raises. fp32: three
    (dq; dk/dv per q head; the group's sum). Counted once."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                       window=window, scale=scale)
    _check(q, k, v, "flash_attention_bwd", BWD_HEAD_DIMS)
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or \
            out.dtype != q.dtype or dout.dtype != q.dtype or \
            tuple(lse.shape) != (B, Hq, S) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} "
                         f"{out.dtype}, dout {tuple(dout.shape)} "
                         f"{dout.dtype}, lse {tuple(lse.shape)} {lse.dtype}")
    _check_group(q, k)
    out, dout, lse = out.contiguous(), dout.contiguous(), lse.contiguous()
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (out, dout)):
        raise ValueError("flash_attention_bwd: bf16 out and dout need "
                         "16-byte aligned bases")
    win = check_window(window)
    scale = scale if scale is not None else hd ** -0.5
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    dtype = _build.DTYPES[q.dtype]
    ws_fn = _build.kernel("flash_attention_bwd",
                          "hydra_flash_attention_bwd_workspace",
                          [ctypes.c_int] * 5, restype=_LL)
    ws = torch.empty(ws_fn(B, S, Hq, hd, dtype), dtype=torch.uint8,
                     device=q.device)
    strides = (_LL * 24)(*(st for t in (q, k, v, out, dout, dq, dk, dv)
                           for st in t.stride()[:3]))
    fn = _build.kernel("flash_attention_bwd", "hydra_flash_attention_bwd",
                       _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             ws.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             B, S, Hq, Hkv, hd, strides, scale, int(causal), win, dtype,
             _build.stream(q))
    _build.check(err, "flash_attention_bwd")
    with _count_lock:
        flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0  # backward calls (2 kernels each, fp32 3)


class FlashAttentionFn(torch.autograd.Function):
    """flash_attention with its hand-written backward: the training path's
    attention. The forward keeps each row's log-sum-exp for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        _check(q, k, v, "flash_attention", BWD_HEAD_DIMS)
        _check_group(q, k)
        B, S, Hq, _ = q.shape
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, causal, window, scale, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         scale=scale)
        return dq, dk, dv, None, None, None
