"""Mamba2 SSD chunked scan: the CUDA kernels ``csrc/ssd_scan.cu`` and
their wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan``
/ ``_kernel``): x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32 and the
single-group Bm/Cm (B,S,N) give y (B,S,H,P) in x's dtype and, on request,
the final state (B,H,P,N) fp32, from ``init_state`` or zeros. The chunk
is taken as given; positions past S act as the reference's ``dt=0``
padding, so the final state is exact.

Bound on the H100: bytes at the serving shapes (x in, y out). bf16, the
serving path, runs the chunked algorithm in three chunk-parallel kernels
on the tensor cores (``ScanPlan`` says how they cut the scan): A, per
(chunk, C Bᵀ tile or head) the lower-triangular C Bᵀ tiles once per
(row, chunk), a_cs by a parallel fp64 scan and each head's chunk state; B,
the state recurrence over the chunks; C, per (64-row tile, chunk, head,
row) the tile's y. Every fp32 operand of a product is split into bf16 hi +
lo, so the products keep about 16 bits. fp32 keeps the first design, one
block per (head, row) walking the chunks with scalar FMAs: the tensor
cores take fp32 only as TF32, too coarse for the fp32 check of 2e-5.
Both read x, Bm, Cm and dt through their strides (the last dim must be
unit stride), so the column slices of the serving path need no copy; an
``init_state`` is made contiguous fp32 first. One call counts one launch,
however many kernels it runs.

The plain version is ``kernels/ref.py:ssd_scan_ref``; the wrapper takes it
only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_ref

HEAD_DIMS = (8, 16, 32, 64, 128)   # P: the kernel is instantiated per P
SMEM_LIMIT = 232448                # bytes of shared memory a block can use
TILE = 64                          # l and s extent of one tile of a chunk
STATE_COLS = 64                    # state columns (n) of one pass-A CTA
TC_THREADS = 128                   # threads of a tensor-core CTA (4 warps)
STATE_THREADS = 256                # threads of a pass-B CTA, 4 elements each
_LL = ctypes.c_longlong
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [_LL] * 13
             + [ctypes.c_int, ctypes.c_void_p])
_count_lock = threading.Lock()


def smem_bytes(P: int, N: int, chunk: int) -> int:
    """Shared memory of one block of the fp32 kernel: state, C and B tiles
    (rows padded by one float), the dt x tile, the masked C B^T tile, dt
    and a_cs."""
    return 4 * (P * (N + 1) + 2 * TILE * (N + 1) + TILE * P
                + TILE * (TILE + 1) + 2 * chunk)


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclass(frozen=True)
class ScanPlan:
    """How the bf16 kernels cut a scan of S positions: ``chunks`` chunks of
    ``chunk`` positions (the last one ragged), each cut into ``l_tiles``
    tiles of 64 rows, of whose (l, s) tile pairs the ``cb_tiles`` on or
    below the diagonal get a C Bᵀ tile. N is padded to ``n_pad`` (a
    multiple of 16) and P to ``p_pad`` (at least 16) with zeros in shared
    memory; a pass-A CTA covers 64 state columns, ``n_blocks`` of them."""
    chunk: int
    chunks: int
    l_tiles: int
    cb_tiles: int
    n_pad: int
    p_pad: int
    n_blocks: int

    def ctas(self, B: int, H: int, P: int, N: int) -> dict:
        """CTAs launched per pass (C Bᵀ tiles past the last chunk's rows,
        and y tiles past S, return at once)."""
        return dict(chunk=self.chunks * (self.cb_tiles + H * self.n_blocks)
                    * B,
                    state=-(-P * N // (4 * STATE_THREADS)) * H * B,
                    out=self.chunks * self.l_tiles * H * B)

    def workspace_shapes(self, B: int, H: int, P: int, N: int) -> dict:
        """The fp32 workspaces: C Bᵀ tiles (B, chunks, cb_tiles, 64, 64);
        a_cs (B, chunks, H, chunk); the chunk states, which pass B
        overwrites with the states entering each chunk (B, chunks, H, P,
        N)."""
        return dict(cb=(B, self.chunks, self.cb_tiles, TILE, TILE),
                    acs=(B, self.chunks, H, self.chunk),
                    state=(B, self.chunks, H, P, N))

    def workspace_offsets(self, B: int, H: int, P: int, N: int) -> tuple:
        """(offsets of the three workspaces in one fp32 buffer, each
        aligned to 64 floats; the buffer's length in floats)."""
        offs, end = [], 0
        for shape in self.workspace_shapes(B, H, P, N).values():
            offs.append(end)
            end += _up(math.prod(shape), 64)
        return tuple(offs), end

    def smem(self) -> dict:
        """Dynamic shared memory of the two tensor-core kernels, in bytes
        (csrc/ssd_scan.cu's chunk_smem_bytes / out_smem_bytes)."""
        pitch = self.n_pad + 8
        cb = 2 * TILE * pitch * 2
        state = (4 * TILE * (self.p_pad + 8) + 8 * TILE * (STATE_COLS + 8)
                 + 8 * self.chunk + 8 * (TC_THREADS // 32))
        out = (2 * (TILE + 2 * self.p_pad) * pitch + 4 * TILE
               * (self.p_pad + 8) + 8 * self.l_tiles * TILE)
        return dict(chunk=max(cb, state), out=out)


@functools.lru_cache(maxsize=None)
def scan_plan(S: int, chunk: int, P: int, N: int) -> ScanPlan:
    """The bf16 kernels' plan. A chunk longer than S is cut to S: the
    reference pads with dt=0, which changes nothing, so the scan is the
    same and the workspaces and tiles shrink."""
    chunk = max(1, min(chunk, S))
    l_tiles = -(-chunk // TILE)
    n_pad = _up(N, 16)
    return ScanPlan(chunk=chunk, chunks=-(-S // chunk), l_tiles=l_tiles,
                    cb_tiles=l_tiles * (l_tiles + 1) // 2, n_pad=n_pad,
                    p_pad=max(P, 16), n_blocks=-(-n_pad // STATE_COLS))


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
    bf16 = x.dtype == torch.bfloat16
    plan = scan_plan(S, chunk, P, N) if bf16 else None
    need = max(plan.smem().values()) if bf16 else smem_bytes(P, N, chunk)
    if need > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: P={P}, N={N}, chunk={chunk} need "
                         f"{need} B of shared memory, over {SMEM_LIMIT}")
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
    ws = (None,) * 3
    if bf16:
        offs, floats = plan.workspace_offsets(B, H, P, N)
        buf = torch.empty(floats, dtype=torch.float32, device=x.device)
        ws = tuple(buf.data_ptr() + 4 * o for o in offs)
        chunk = plan.chunk
    fn = _build.kernel("ssd_scan", "hydra_ssd_scan", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), ptr(init_state), y.data_ptr(), ptr(final), *ws,
             B, S, H, P, N, chunk, *x.stride()[:3], *dt.stride(),
             *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3],
             _build.DTYPES[x.dtype], _build.stream(x))
    _build.check(err, "ssd_scan")
    with _count_lock:
        ssd_scan.launches += 1
    return (y, final) if return_state else y


ssd_scan.launches = 0     # kernel launches since the last reset
