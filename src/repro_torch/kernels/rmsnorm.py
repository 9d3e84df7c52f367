"""RMSNorm: the hand-written CUDA kernel ``csrc/rmsnorm.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py``
(``rmsnorm`` / ``_kernel``): ``x * rsqrt(mean(x²) + eps) * (1 + w)`` in
fp32 over the last dim, stored in x's dtype.

Bound on the H100: bytes (x read, out written, 3 flops per element).
The kernel gives each row one block and reduces the sum of squares in
registers and shared memory, so x makes one trip from device memory and
the second read of the row is served by the cache.

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


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    D = x.shape[-1]
    if not x.is_cuda or w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    if x.dtype not in _build.DTYPES or w.dtype not in _build.DTYPES:
        raise TypeError(f"rmsnorm: unsupported dtypes {x.dtype}, {w.dtype}")
    if tuple(w.shape) != (D,):
        raise ValueError(f"rmsnorm: w shape {tuple(w.shape)} != ({D},)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    fn = _build.kernel("rmsnorm", "hydra_rmsnorm", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, D, eps,
             _build.DTYPES[x.dtype], _build.DTYPES[w.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rmsnorm")
    with _count_lock:
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0      # kernel launches since the last reset
