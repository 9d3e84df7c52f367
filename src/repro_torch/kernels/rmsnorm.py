"""RMSNorm: the hand-written CUDA kernel ``csrc/rmsnorm.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py``
(``rmsnorm`` / ``_kernel``): ``x * rsqrt(mean(x²) + eps) * (1 + w)`` in
fp32 over the last dim, stored in x's dtype.

Bound on the H100: bytes (x read, out written, 3 flops per element); at
the 4 rows of a decode step, launch latency and the host's cost per call.
The kernel gives each row one warp, up to 8 rows per block, and keeps the
row in registers (16-byte loads) between the warp-shuffle reduction and
the scale, so x makes one trip from device memory. The wrapper runs on
every norm of every layer (73 calls per qwen2.5-3b decode step), so it
keeps its host work small: the C entry resolved once, the raw stream
pointer, the checks on plain attributes; alignment is the kernel's
concern (an unaligned or odd-width row takes its scalar variant).

The backward, ``csrc/rmsnorm_bwd.cu`` (``rmsnorm_bwd``), has no TPU
counterpart: the reference differentiates the jnp oracle. ``RMSNormFn``
binds the two as a ``torch.autograd.Function``, which ``kernels/ops``
takes for CUDA tensors under autograd (the training path).

The plain versions are ``kernels/ref.py:rmsnorm_ref`` and
``rmsnorm_bwd_ref``; the wrappers take them only for tensors that lie on
the CPU.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_bwd_ref, rmsnorm_ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
_count_lock = threading.Lock()
_fn = None                # the C entry, once built and loaded


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    global _fn
    if not x.is_cuda:
        if x.device.type == "cpu":
            return rmsnorm_ref(x, w, eps)
        raise ValueError(f"rmsnorm: x on {x.device}")
    xd, wd = _build.DTYPES.get(x.dtype), _build.DTYPES.get(w.dtype)
    if xd is None or wd is None:
        raise TypeError(f"rmsnorm: unsupported dtypes {x.dtype}, {w.dtype}")
    if w.get_device() != x.get_device():
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    D = x.shape[-1]
    if w.dim() != 1 or w.shape[0] != D:
        raise ValueError(f"rmsnorm: w shape {tuple(w.shape)} != ({D},)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    out = torch.empty_like(x)
    if _fn is None:
        _fn = _build.kernel("rmsnorm", "hydra_rmsnorm", _ARGTYPES)
    err = _fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
              x.numel() // D if D else 0, D, eps, xd, wd, _build.stream(x))
    if err:
        _build.check(err, "rmsnorm")
    with _count_lock:
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0      # kernel launches since the last reset


def rmsnorm_bwd(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-5) -> tuple:
    """(dx in x's dtype, dw in w's dtype) for the output grad ``dy``."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(dy, x, w, eps)
    xd, wd = _build.DTYPES.get(x.dtype), _build.DTYPES.get(w.dtype)
    if not x.is_cuda or xd is None or wd is None or dy.dtype != x.dtype:
        raise TypeError(f"rmsnorm_bwd: x {x.dtype} on {x.device}, w "
                        f"{w.dtype}, dy {dy.dtype}")
    D = x.shape[-1]
    if dy.shape != x.shape or w.dim() != 1 or w.shape[0] != D or \
            dy.device != x.device or w.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)}, x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_bwd: x and w must be contiguous")
    dy = dy.contiguous()
    rows = x.numel() // D if D else 0
    fn = _build.kernel("rmsnorm_bwd", "hydra_rmsnorm_bwd", _BWD_ARGTYPES)
    ws_fn = _build.kernel("rmsnorm_bwd", "hydra_rmsnorm_bwd_workspace",
                          [ctypes.c_longlong, ctypes.c_int],
                          restype=ctypes.c_longlong)
    ws = torch.empty(ws_fn(rows, D), dtype=torch.float32, device=x.device)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    _build.check(fn(dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(),
                    dw.data_ptr(), ws.data_ptr(), rows, D, eps, xd, wd,
                    _build.stream(x)), "rmsnorm_bwd")
    with _count_lock:
        rmsnorm_bwd.launches += 1
    return dx, dw


rmsnorm_bwd.launches = 0  # backward calls (3 kernels each) since the last reset


class RMSNormFn(torch.autograd.Function):
    """rmsnorm with its hand-written backward: the training path's norm."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(dy, x, w, eps=ctx.eps)
        return dx, dw, None
