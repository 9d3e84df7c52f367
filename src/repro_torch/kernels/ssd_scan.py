"""Mamba2 SSD chunked scan: the CUDA kernels ``csrc/ssd_scan.cu`` and
their wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan``
/ ``_kernel``): x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32 and Bm/Cm, one
B/C group (B,S,N) or G groups (B,S,G,N) whose group g the heads
[g H/G, (g+1) H/G) read, give y (B,S,H,P) in x's dtype and, on request,
the final state (B,H,P,N) fp32, from ``init_state`` or zeros. One group
as (B,S,N) or (B,S,1,N) makes the same launches and results. A chunk
longer than S is cut to S (``scan_plan``); positions past S act as the
reference's ``dt=0`` padding, so the scan and the final state are exact.

Bound on the H100: bytes at the serving shapes (x in, y out). bf16, the
serving path, runs the chunked algorithm in three chunk-parallel kernels
on the tensor cores (``ScanPlan`` says how they cut the scan): A, per
(chunk, C Bᵀ tile or head) the lower-triangular C Bᵀ tiles once per
(row, chunk, group), a_cs by a parallel fp64 scan and each head's chunk state; B,
the state recurrence over the chunks; C, per (64-row tile, chunk, head,
row) the tile's y. Every fp32 operand of a product is split into bf16 hi +
lo, so the products keep about 16 bits. fp32 keeps the first design, one
block per (head, row) walking the chunks with scalar FMAs: the tensor
cores take fp32 only as TF32, too coarse for the fp32 check of 2e-5.
Both read x, Bm, Cm and dt through their strides (the last dim must be
unit stride), so the column slices of the serving path need no copy; an
``init_state`` is made contiguous fp32 first. One call counts one launch,
however many kernels it runs.

Training: ``SsdScanFn`` (a ``torch.autograd.Function``, taken by
``kernels/ops`` for CUDA tensors under autograd) runs the forward, keeps
a_cs and the states entering each chunk (the bf16 kernels' workspaces;
the fp32 kernel writes them on request) and differentiates with the
hand-written backward ``csrc/ssd_scan_bwd.cu`` (``ssd_scan_bwd``: dx,
ddt, dA, dB, dC and d init_state, counted as one call; ``BwdPlan`` says
which kernels run and how they cut it: bf16 a fused pass per (row,
chunk, head) on the tensor cores in clusters of heads, with U_c and the
recurrence only where the state is not zero; fp32 seven scalar
kernels), which has no TPU counterpart: the reference differentiates
the jnp oracle. The backward takes one B/C group: with more it raises.

The plain versions are ``kernels/ref.py:ssd_scan_ref`` and
``ssd_scan_bwd_ref``; the wrappers take them only for tensors that lie on
the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_bwd_ref, ssd_scan_ref

HEAD_DIMS = (8, 16, 32, 64, 128)   # P: the kernel is instantiated per P
SMEM_LIMIT = 232448                # bytes of shared memory a block can use
TILE = 64                          # l and s extent of one tile of a chunk
STATE_COLS = 64                    # state columns (n) of one pass-A CTA
TC_THREADS = 128                   # threads of a tensor-core CTA (4 warps)
STATE_THREADS = 256                # threads of a pass-B CTA, 4 elements each
_LL = ctypes.c_longlong
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [_LL] * 13
             + [ctypes.c_int, _LL, _LL, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 7 + [_LL] * 13
                 + [ctypes.c_int, ctypes.c_void_p])
BWD_MAX_N = 128                    # the backward's widest state (N) bucket
BWD_THREADS = 256                  # threads of a backward CTA
BWD_CLUSTER = 8                    # most heads per cluster (the portable size)
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

    def ctas(self, B: int, H: int, P: int, N: int, groups: int = 1) -> dict:
        """CTAs launched per pass (C Bᵀ tiles past the last chunk's rows,
        and y tiles past S, return at once)."""
        return dict(chunk=self.chunks * (groups * self.cb_tiles
                                         + H * self.n_blocks) * B,
                    state=-(-P * N // (4 * STATE_THREADS)) * H * B,
                    out=self.chunks * self.l_tiles * H * B)

    def workspace_shapes(self, B: int, H: int, P: int, N: int,
                         groups: int = 1) -> dict:
        """The fp32 workspaces: C Bᵀ tiles (B, chunks, cb_tiles, 64, 64),
        with a groups axis after chunks where there is more than one;
        a_cs (B, chunks, H, chunk); the chunk states, which pass B
        overwrites with the states entering each chunk (B, chunks, H, P,
        N)."""
        lead = (B, self.chunks) + ((groups,) if groups > 1 else ())
        return dict(cb=lead + (self.cb_tiles, TILE, TILE),
                    acs=(B, self.chunks, H, self.chunk),
                    state=(B, self.chunks, H, P, N))

    def workspace_offsets(self, B: int, H: int, P: int, N: int,
                          groups: int = 1) -> tuple:
        """(offsets of the three workspaces in one fp32 buffer, each
        aligned to 64 floats; the buffer's length in floats)."""
        offs, end = [], 0
        for shape in self.workspace_shapes(B, H, P, N, groups).values():
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


def _bwd_buckets(P: int, N: int) -> tuple:
    """The backward's P and N buckets: P padded to at least 16, N to 64 or
    128 (its kernels are instantiated per bucket)."""
    return max(P, 16), 64 if N <= 64 else 128


def bwd_smem_bytes(P: int, N: int, chunk: int) -> dict:
    """Dynamic shared memory of the backward's kernels, in bytes
    (csrc/ssd_scan_bwd.cu's bwd_smem). fp32 (``cb``, ``dstate``, ``s``,
    ``l``, ``combine``): fp32 tiles with odd row pitches; the s and l
    kernels hold the (P, N) state and the tile it multiplies (B, C) in a
    union with the operands of their loop over l or s tiles; combine an
    fp64 value per position. bf16 (``mma``, ``mma_long``, ``mma_state``):
    bf16 tiles with pitches padded by 8; the fused pass holds x and B of
    an s tile, dy and C of an l tile, dCB and M as hi + lo (their union:
    the fp32 staging tile of the cluster's sum), six per-position fp32
    arrays over the chunk's 64-row tiles (``mma_long``: those six in
    device memory, for a chunk too long for them), six of 64 for the
    partial sums and 24 fp64 partials of the reverse cumsum."""
    pb, nb = _bwd_buckets(P, N)
    pp, np_, t, tp = pb + 1, nb + 1, TILE, TILE + 1
    g = (pp - 1) * np_
    s_tiles = t * np_ + t * pp + t * tp + 16 * t
    l_tiles = t * np_ + t * pp + t * tp
    L, xp, bp = _up(chunk, TILE), pb + 8, nb + 8
    mma_long = (2 * (2 * t * xp + 2 * t * bp + 4 * t * (t + 8))
                + 4 * 6 * t + 8 * 3 * (BWD_THREADS // 32))
    return dict(cb=4 * 2 * t * np_,
                dstate=4 * (t * pp + t * np_ + chunk),
                s=4 * (t * pp + chunk + 3 * t + max(g + t * np_, s_tiles)),
                l=4 * (t * pp + chunk + max(g + t * np_, l_tiles)),
                combine=8 * chunk,
                mma=mma_long + 4 * 6 * L, mma_long=mma_long,
                mma_state=2 * (2 * t * xp + t * bp))


def bwd_cluster(H: int) -> int:
    """Heads per cluster of the bf16 fused pass: the largest divisor of H
    up to 8, so the clusters tile the heads."""
    return max(d for d in range(1, BWD_CLUSTER + 1) if H % d == 0)


@dataclass(frozen=True)
class BwdPlan:
    """What the backward of ``plan`` runs and how it cuts it, for one route:
    ``tc`` the bf16 tensor-core kernels, else the fp32 scalar ones; ``init``
    and ``dfinal`` whether an init state and a final-state cotangent were
    given.

    fp32 (seven kernels): C Bᵀ tiles, U_c, the recurrence, s-side and
    l-side tile passes, combine, reduce; workspaces: C Bᵀ tiles (B, chunks,
    cb_tiles, 64, 64); U_c, then G_{c+1} (B, chunks, H, P, N); the per-head
    partial dB and dC (B, H, S, N); the per-position row part, column part,
    r and <x, d dtx> (4, B, chunks, H, chunk); the partial dA (B, chunks,
    H) in fp64, as two floats each.

    bf16: U_c (``mma_state``) only where G can be nonzero or d init_state is
    wanted (chunks after the first, chunk 0 only with an init state); the
    recurrence (``grec``) only with more than one chunk, an init state or a
    final-state cotangent; the fused pass (``mma``), one CTA per (row,
    chunk, head) in clusters of ``bwd_cluster(H)`` heads; the reduction.
    Workspaces: G (B, chunks, H, P, N) where the recurrence runs; the
    clusters' partial dB and dC (B, H / cluster, S, N rounded up to 4);
    the fused pass's six per-position arrays (B, chunks, H, 6, l_tiles
    64) only where they do not fit its shared memory (``long_chunk``);
    parked dC tiles (B, chunks, H, l_tiles - 1, 64 NB), NB the N bucket,
    only where a chunk has three or more 64-row tiles; the partial dA."""
    plan: ScanPlan
    tc: bool = False
    init: bool = False
    dfinal: bool = False

    def runs(self) -> tuple:
        """(U_c runs for chunks [c_lo, chunks), the recurrence runs)."""
        p = self.plan
        c_lo = 0 if self.init else 1
        return c_lo, p.chunks > 1 or self.init or self.dfinal

    def long_chunk(self, P: int, N: int) -> bool:
        """Whether the bf16 fused pass keeps its six per-position arrays in
        device memory: they do not fit beside its tiles."""
        return self.tc and \
            bwd_smem_bytes(P, N, self.plan.chunk)["mma"] > SMEM_LIMIT

    def ctas(self, B: int, S: int, H: int, P: int, N: int) -> dict:
        """CTAs per kernel that runs."""
        p = self.plan
        nch = p.chunks * H
        reduce = -(-B * S * N // BWD_THREADS) + -(-H // BWD_THREADS)
        grec = -(-P * N // BWD_THREADS) * H * B
        if not self.tc:
            return dict(cb=p.cb_tiles * p.chunks * B, dstate=nch * B,
                        grec=grec, s=p.l_tiles * nch * B,
                        l=p.l_tiles * nch * B, combine=nch * B,
                        reduce=reduce)
        c_lo, rec = self.runs()
        out = {}
        if p.chunks > c_lo:
            out["mma_state"] = (p.chunks - c_lo) * H * B
        if rec:
            out["grec"] = grec
        out["mma"] = nch * B
        out["reduce"] = reduce
        return out

    def workspace_shapes(self, B: int, S: int, H: int, P: int,
                         N: int) -> dict:
        p = self.plan
        if not self.tc:
            return dict(cb=(B, p.chunks, p.cb_tiles, TILE, TILE),
                        g=(B, p.chunks, H, P, N), dbp=(B, H, S, N),
                        dcp=(B, H, S, N), pos=(4, B, p.chunks, H, p.chunk),
                        dap=(B, p.chunks, H, 2))
        parts, nw = H // bwd_cluster(H), _up(N, 4)
        out = {}
        if self.runs()[1]:
            out["g"] = (B, p.chunks, H, P, N)
        out.update(dbp=(B, parts, S, nw), dcp=(B, parts, S, nw))
        if self.long_chunk(P, N):
            out["pos"] = (B, p.chunks, H, 6, p.l_tiles * TILE)
        if p.l_tiles >= 3:
            out["pend"] = (B, p.chunks, H, p.l_tiles - 1,
                           TILE * _bwd_buckets(P, N)[1])
        out["dap"] = (B, p.chunks, H, 2)
        return out

    def workspace_offsets(self, B: int, S: int, H: int, P: int,
                          N: int) -> tuple:
        """(offsets of the workspaces, in ``workspace_shapes``' order, in
        one fp32 buffer, each aligned to 64 floats; the buffer's length in
        floats)."""
        offs, end = [], 0
        for shape in self.workspace_shapes(B, S, H, P, N).values():
            offs.append(end)
            end += _up(math.prod(shape), 64)
        return tuple(offs), end

    def smem(self, P: int, N: int) -> dict:
        """Dynamic shared memory of this route's kernels, in bytes (bf16:
        ``mma`` as the fused pass launches, with ``long_chunk``'s
        layout)."""
        m = bwd_smem_bytes(P, N, self.plan.chunk)
        if self.tc:
            mma = "mma_long" if self.long_chunk(P, N) else "mma"
            return dict(mma=m[mma], mma_state=m["mma_state"])
        return {k: m[k] for k in ("cb", "dstate", "s", "l", "combine")}


@functools.lru_cache(maxsize=None)
def scan_plan(S: int, chunk: int, P: int, N: int) -> ScanPlan:
    """The kernels' plan: the bf16 forward's tiles, and the chunk of both
    forwards and the backward. A chunk longer than S is cut to S: the
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
    """-> y (B,S,H,P) [, final_state (B,H,P,N) fp32]. Bm, Cm (B,S,N) or
    (B,S,G,N)."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state, return_state=return_state)
    y, final, _ = _forward(x, dt, A, Bm, Cm, chunk, init_state, return_state,
                           save=False)
    return (y, final) if return_state else y


ssd_scan.launches = 0     # kernel launches since the last reset


def groups_of(Bm: torch.Tensor) -> int:
    """B/C groups of Bm: 1 for (B,S,N), G for (B,S,G,N)."""
    return Bm.shape[2] if Bm.dim() == 4 else 1


def _check(x, dt, A, Bm, Cm, init_state, chunk, what: str) -> None:
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    G = groups_of(Bm)
    tensors = [x, dt, A, Bm, Cm] + ([init_state] if init_state is not None
                                    else [])
    if not x.is_cuda or any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: all inputs must share one CUDA device")
    if x.dtype not in _build.DTYPES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"{what}: x, Bm, Cm dtypes {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}; need one of fp32/bf16 for all three")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{what}: dt and A must be fp32, got {dt.dtype}, "
                        f"{A.dtype}")
    bc = (B, S, N) if Bm.dim() == 3 else (B, S, G, N)
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape) != bc or Cm.shape != Bm.shape or H % G:
        raise ValueError(f"{what}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if P not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim P={P} not in {HEAD_DIMS}")
    if isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"{what}: chunk must be an int >= 1, got {chunk}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)) \
            or not A.is_contiguous():
        raise ValueError(f"{what}: the last dim of x, Bm, Cm must be "
                         f"contiguous, and A contiguous")
    if init_state is not None and tuple(init_state.shape) != (B, H, P, N):
        raise ValueError(f"{what}: init_state shape "
                         f"{tuple(init_state.shape)} != {(B, H, P, N)}")


def _forward(x, dt, A, Bm, Cm, chunk, init_state, return_state, save):
    """One forward call -> (y, final state or None, (a_cs, states) or
    None): with ``save`` the a_cs (B, chunks, H, chunk) and the states
    entering each chunk (B, chunks, H, P, N), fp32 views of the call's
    workspace that the backward reads."""
    _check(x, dt, A, Bm, Cm, init_state, chunk, "ssd_scan")
    B, S, H, P = x.shape
    N, G = Bm.shape[-1], groups_of(Bm)
    bf16 = x.dtype == torch.bfloat16
    plan = scan_plan(S, chunk, P, N)
    need = max(plan.smem().values()) if bf16 else \
        smem_bytes(P, N, plan.chunk)
    if need > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: P={P}, N={N}, chunk={chunk} need "
                         f"{need} B of shared memory, over {SMEM_LIMIT}")
    if init_state is not None:
        init_state = init_state.to(torch.float32).contiguous()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    final = (torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
             if return_state else None)
    ptr = lambda t: t.data_ptr() if t is not None else None
    ws, saved = (None,) * 3, None
    if bf16 or save:
        offs, floats = plan.workspace_offsets(B, H, P, N, G)
        buf = torch.empty(floats, dtype=torch.float32, device=x.device)
        ws = tuple(buf.data_ptr() + 4 * o for o in offs)
        if save:
            shapes = plan.workspace_shapes(B, H, P, N, G)
            saved = tuple(buf[o:o + math.prod(shapes[k])].view(shapes[k])
                          for o, k in zip(offs[1:], ("acs", "state")))
    fn = _build.kernel("ssd_scan", "hydra_ssd_scan", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), ptr(init_state), y.data_ptr(), ptr(final), *ws,
             B, S, H, P, N, plan.chunk, *x.stride()[:3], *dt.stride(),
             *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3], G,
             Bm.stride(2) if G > 1 else 0, Cm.stride(2) if G > 1 else 0,
             _build.DTYPES[x.dtype], _build.stream(x))
    _build.check(err, "ssd_scan")
    with _count_lock:
        ssd_scan.launches += 1
    return y, final, saved


def ssd_scan_bwd(dy: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                 A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
                 chunk: int = 64, init_state: torch.Tensor | None = None,
                 dfinal: torch.Tensor | None = None, saved=None) -> tuple:
    """(dx, ddt, dA, dB, dC, d init_state or None) for y's cotangent ``dy``
    (x's dtype) and, optionally, the final state's ``dfinal`` (B,H,P,N):
    dx, dB, dC in x's dtype, the rest fp32. ``saved`` is the forward's
    (a_cs, states) (``_forward(..., save=True)``), required for CUDA
    tensors. One call counts one launch, however many kernels it runs
    (``BwdPlan.ctas``): bf16 two with one chunk and neither an init state
    nor ``dfinal`` (the training shapes), up to four; fp32 seven."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_ref(dy, x, dt, A, Bm, Cm, chunk=chunk,
                                init_state=init_state, dfinal=dfinal)
    _check(x, dt, A, Bm, Cm, init_state, chunk, "ssd_scan_bwd")
    if groups_of(Bm) > 1:
        raise NotImplementedError(
            f"ssd_scan_bwd: {groups_of(Bm)} B/C groups; the backward kernels "
            f"take one group (serving takes more, training does not yet)")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if N > BWD_MAX_N:
        raise ValueError(f"ssd_scan_bwd: N={N} over {BWD_MAX_N}")
    plan = scan_plan(S, chunk, P, N)
    bplan = BwdPlan(plan, tc=x.dtype == torch.bfloat16,
                    init=init_state is not None, dfinal=dfinal is not None)
    need = max(bplan.smem(P, N).values())
    if need > SMEM_LIMIT:
        raise ValueError(f"ssd_scan_bwd: P={P}, N={N}, chunk={chunk} need "
                         f"{need} B of shared memory, over {SMEM_LIMIT}")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"on {dy.device}, x {tuple(x.shape)} {x.dtype}")
    if dy.stride(-1) != 1:      # e.g. an expanded cotangent
        dy = dy.contiguous()
    if dfinal is not None:
        if tuple(dfinal.shape) != (B, H, P, N) or \
                dfinal.device != x.device:
            raise ValueError(f"ssd_scan_bwd: dfinal shape "
                             f"{tuple(dfinal.shape)} != {(B, H, P, N)}")
        dfinal = dfinal.to(torch.float32).contiguous()
    if saved is None:
        raise ValueError("ssd_scan_bwd: needs the forward's saved a_cs and "
                         "states (_forward(..., save=True))")
    acs, states = saved
    shapes = plan.workspace_shapes(B, H, P, N)
    if tuple(acs.shape) != shapes["acs"] or \
            tuple(states.shape) != shapes["state"] or \
            not (acs.is_contiguous() and states.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd: saved a_cs {tuple(acs.shape)} and "
                         f"states {tuple(states.shape)} do not match the "
                         f"plan's {shapes['acs']}, {shapes['state']}")
    offs, floats = bplan.workspace_offsets(B, S, H, P, N)
    buf = torch.empty(floats, dtype=torch.float32, device=x.device)
    ws = dict(zip(bplan.workspace_shapes(B, S, H, P, N),
                  (buf.data_ptr() + 4 * o for o in offs)))
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=x.device)
    dA = torch.empty((H,), dtype=torch.float32, device=x.device)
    dB = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    dC = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    dinit = (torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is not None else None)
    ptr = lambda t: t.data_ptr() if t is not None else None
    fn = _build.kernel("ssd_scan_bwd", "hydra_ssd_scan_bwd", _BWD_ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), dy.data_ptr(), ptr(dfinal), acs.data_ptr(),
             states.data_ptr(), *(ws.get(k) for k in (
                 "cb", "g", "dbp", "dcp", "pos", "pend", "dap")),
             dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
             dC.data_ptr(), ptr(dinit), B, S, H, P, N, plan.chunk,
             bwd_cluster(H), *x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
             *Cm.stride()[:2], *dy.stride()[:3], _build.DTYPES[x.dtype],
             _build.stream(x))
    _build.check(err, "ssd_scan_bwd")
    with _count_lock:
        ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dinit


ssd_scan_bwd.launches = 0  # backward calls (2-4 kernels bf16, 7 fp32)


class SsdScanFn(torch.autograd.Function):
    """ssd_scan with its hand-written backward: the training path's scan.
    The forward keeps a_cs and the states entering each chunk; under
    ``torch.utils.checkpoint`` they come from the rerun forward, which is
    bit-equal to the first."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk, return_state):
        y, final, saved = _forward(x, dt, A, Bm, Cm, chunk, init_state,
                                   return_state, save=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state, *saved)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return (y, final) if return_state else y

    @staticmethod
    def backward(ctx, dy, dfinal=None):
        x, dt, A, Bm, Cm, init, acs, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x, memory_format=torch.contiguous_format)
        dx, ddt, dA, dB, dC, dinit = ssd_scan_bwd(
            dy, x, dt, A, Bm, Cm, chunk=ctx.chunk, init_state=init,
            dfinal=dfinal, saved=(acs, states))
        if dinit is not None:
            dinit = dinit.to(init.dtype)
        return dx, ddt, dA, dB, dC, dinit, None, None
