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

The plain version is ``kernels/ref.py:rmsnorm_ref``; the wrapper takes it
only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
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
