"""Mamba2 SSD chunked scan: the CUDA kernel ``csrc/ssd_scan.cu`` and its
wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan``
/ ``_kernel``): x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32 and the
single-group Bm/Cm (B,S,N) give y (B,S,H,P) in x's dtype and, on request,
the final state (B,H,P,N) fp32, from ``init_state`` or zeros. The chunk
is taken as given; positions past S act as the reference's ``dt=0``
padding, so the final state is exact.

Bound on the H100: bytes at the serving shapes (x in, y out). The kernel
gives one block to each (head, batch row), loops over the chunks in order
with the (P, N) state in shared memory, and tiles the chunk's (l, s)
products 64 x 64 so that a chunk of 256 with N = 128 fits a block. It
reads x, Bm, Cm and dt through their strides (the last dim must be unit
stride), so the column slices of the serving path need no copy; an
``init_state`` is made contiguous fp32 first.

The plain version is ``kernels/ref.py:ssd_scan_ref``; the wrapper takes it
only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_ref

HEAD_DIMS = (8, 16, 32, 64, 128)   # P: the kernel is instantiated per P
SMEM_LIMIT = 232448                # bytes of shared memory a block can use
TILE = 64                          # l and s extent of one tile of a chunk
_LL = ctypes.c_longlong
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [_LL] * 13
             + [ctypes.c_int, ctypes.c_void_p])
_count_lock = threading.Lock()


def smem_bytes(P: int, N: int, chunk: int) -> int:
    """Shared memory of one block: state, C and B tiles (rows padded by
    one float), the dt x tile, the masked C B^T tile, dt and a_cs."""
    return 4 * (P * (N + 1) + 2 * TILE * (N + 1) + TILE * P
                + TILE * (TILE + 1) + 2 * chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 64,
             init_state: torch.Tensor | None = None,
             return_state: bool = False):
    """-> y (B,S,H,P) [, final_state (B,H,P,N) fp32]."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state, return_state=return_state)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    tensors = [x, dt, A, Bm, Cm] + ([init_state] if init_state is not None
                                    else [])
    if not x.is_cuda or any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: all inputs must share one CUDA device")
    if x.dtype not in _build.DTYPES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, Bm, Cm dtypes {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}; need one of fp32/bf16 for all three")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and A must be fp32, got {dt.dtype}, "
                        f"{A.dtype}")
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape) != (B, S, N) or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_scan: head dim P={P} not in {HEAD_DIMS}")
    if isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be an int >= 1, got {chunk}")
    if smem_bytes(P, N, chunk) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: P={P}, N={N}, chunk={chunk} need "
                         f"{smem_bytes(P, N, chunk)} B of shared memory, "
                         f"over {SMEM_LIMIT}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)) \
            or not A.is_contiguous():
        raise ValueError("ssd_scan: the last dim of x, Bm, Cm must be "
                         "contiguous, and A contiguous")
    if init_state is not None:
        if tuple(init_state.shape) != (B, H, P, N):
            raise ValueError(f"ssd_scan: init_state shape "
                             f"{tuple(init_state.shape)} != {(B, H, P, N)}")
        init_state = init_state.to(torch.float32).contiguous()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    final = (torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
             if return_state else None)
    ptr = lambda t: t.data_ptr() if t is not None else None
    fn = _build.kernel("ssd_scan", "hydra_ssd_scan", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), ptr(init_state), y.data_ptr(), ptr(final),
             B, S, H, P, N, chunk, *x.stride()[:3], *dt.stride(),
             *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3],
             _build.DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan")
    with _count_lock:
        ssd_scan.launches += 1
    return (y, final) if return_state else y


ssd_scan.launches = 0     # kernel launches since the last reset
