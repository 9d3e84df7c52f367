"""The SSD scan's fp32 backward kernels (``kernels/csrc/ssd_scan_bwd.cu``,
the scalar route), emulated on the CPU on their own tiling, and the
backward's plan (``BwdPlan``) for both routes; the bf16 tensor-core route
is emulated in ``tests/test_torch_ssd_bwd_tc.py``.

The CUDA kernels run only on the card, so this file replays their passes
in torch, with ``scan_plan``'s chunks and 64 x 64 tiles, the same masks
and the same order of every sum:

* ``bwd_cb_kernel``: C Bᵀ of each lower-triangular tile, once per (row,
  chunk);
* ``bwd_dstate_kernel``: per (row, chunk, head) U = Σ_l exp(a_cs[l])
  dy[l]ᵀ C[l];
* ``bwd_grec_kernel``: the reverse recurrence over the chunks, G_c =
  G_{c+1} exp(a_cs_c[-1]) + U_c from the final state's cotangent (or 0);
  it keeps G_{c+1} per chunk and writes d init_state = G_0;
* ``bwd_s_kernel``, per (64-row s tile, chunk, head, row): the gradients
  indexed by s — d(dt x)[s] from the l tiles on or below the diagonal and
  the chunk-state term, dx, ⟨x, d(dt x)⟩, the head's partial dB, and the
  column sums of E = (C Bᵀ) o L o ⟨dy, dt x⟩;
* ``bwd_l_kernel``, per (64-row l tile, chunk, head, row): those indexed
  by l — the head's partial dC and the row sums of E plus ⟨dy, Y_off⟩;
* ``bwd_combine_kernel``, per (row, chunk, head): d a_cs, its reverse
  cumsum accumulated in fp64 (d a), ddt and the partial dA;
* ``bwd_reduce_kernel``: dB and dC summed over the heads, dA over rows
  and chunks, each in a fixed order.

The forward's saved workspaces (a_cs and the states entering each chunk)
are emulated as ``kernels/csrc/ssd_scan.cu`` writes them: a_cs an fp64
cumsum rounded once, each chunk state a product whose fp32 operand is
split into bf16 hi + lo on the bf16 path.

The emulation is held against ``torch.autograd`` of the scan's definition
(a float64 recurrence, 1e-9), against ``jax.vjp`` of
the JAX oracle ``repro.kernels.ref.ssd_scan_ref`` in fp32 (each gradient
within 2e-5 of its largest |g|, dA of the sum of its terms' absolute
values (``dA_scale``), d init_state 1e-3 as the forward's state is held).
Each side's tile loops must visit every (l, s) pair on or below the
diagonal exactly once. Three of these cases also run the bf16 route's
emulation against the JAX oracle on the same bf16 inputs (5e-2). The
plan's shared memory is held to every chunk the forward takes. Inputs
are drawn with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import (SMEM_LIMIT, TILE, BwdPlan,
                                          bwd_cluster, bwd_smem_bytes,
                                          scan_plan, ssd_scan_bwd)
from repro_torch.kernels.ssd_scan import smem_bytes as fwd_smem_bytes

CASES = [  # B, S, H, P, N, chunk, init, final-state cotangent
    (2, 100, 3, 16, 16, 32, True, True),      # ragged S, 4 chunks, both
    (1, 300, 2, 64, 64, 256, True, True),     # chunk 256, N 64 (zamba2)
    (1, 200, 2, 64, 128, 128, False, True),   # N 128 (mamba2), 2 chunks
    (2, 33, 2, 16, 64, 8, False, False),      # chunk 8
    (1, 5, 2, 16, 16, 5, False, False),       # chunk = S < 8
    (1, 130, 2, 32, 20, 64, True, False),     # N 20, P 32, 3 chunks
    (2, 128, 2, 64, 64, 128, False, False),   # the training shape's chunk
]
GRADS = ("dx", "ddt", "dA", "dB", "dC")
F32_TOL = 2e-5
BF16_TOL = 5e-2
STATE_TOL = 1e-3


def hi_lo(v: torch.Tensor) -> torch.Tensor:
    """v as bf16 hi + lo summed in fp32 (exact: the two carry ~16 bits)."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def saved_workspaces(x, dt, A, Bm, Cm, init, plan, split):
    """The forward's a_cs (B, chunks, H, chunk) and states entering each
    chunk (B, chunks, H, P, N), as the forward kernels write them."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    ft = x.dtype
    L, nc = plan.chunk, plan.chunks
    acs_ws = torch.zeros((Bsz, nc, H, L), dtype=ft)
    st_ws = torch.zeros((Bsz, nc, H, P, N), dtype=ft)
    cur = init.clone() if init is not None else \
        torch.zeros((Bsz, H, P, N), dtype=ft)
    rnd = hi_lo if split else (lambda v: v)
    for c in range(nc):
        c0 = c * L
        Lc = min(L, S - c0)
        acs = torch.cumsum((dt[:, c0:c0 + Lc] * A).double(), 1).to(ft)
        acs_ws[:, c, :, :Lc] = acs.transpose(1, 2)
        fac = dt[:, c0:c0 + Lc] * torch.exp(acs[:, -1:] - acs)  # (B, Lc, H)
        W = rnd(fac[..., None] * Bm[:, c0:c0 + Lc, None, :])     # (B,Lc,H,N)
        sc = torch.einsum("blhp,blhn->bhpn", x[:, c0:c0 + Lc], W)
        st_ws[:, c] = cur
        cur = cur * torch.exp(acs[:, -1])[..., None, None] + sc
    return acs_ws, st_ws


def bwd_passes(x, dt, A, Bm, Cm, dy, dfinal, acs_ws, st_ws, plan):
    """The backward kernels' passes on CPU tensors of one float dtype, in
    that dtype (d a's cumsum in fp64, dA's partials in fp64). ->
    (dict of gradients, the s-side and l-side visit counts (B, chunks,
    H, pad, pad))."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    ft = x.dtype
    L, nc, T, nlt = plan.chunk, plan.chunks, TILE, plan.l_tiles
    pad = nlt * T
    tri = lambda lt, st: lt * (lt + 1) // 2 + st
    f64 = torch.float64

    def rows(m, b, c0, Lc):             # a chunk's rows, zero past Lc
        out = torch.zeros((pad,) + tuple(m.shape[2:]), dtype=ft)
        out[:Lc] = m[b, c0:c0 + Lc]
        return out

    # bwd_cb_kernel
    cb = torch.zeros((Bsz, nc, plan.cb_tiles, T, T), dtype=ft)
    for b in range(Bsz):
        for c in range(nc):
            Lc = min(L, S - c * L)
            Cc, Bc = rows(Cm, b, c * L, Lc), rows(Bm, b, c * L, Lc)
            for lt in range(nlt):
                for st in range(lt + 1):
                    if lt * T < Lc:
                        cb[b, c, tri(lt, st)] = \
                            Cc[lt * T:(lt + 1) * T] @ Bc[st * T:(st + 1) * T].T
    # bwd_dstate_kernel
    U = torch.zeros((Bsz, nc, H, P, N), dtype=ft)
    for b in range(Bsz):
        for c in range(nc):
            c0 = c * L
            Lc = min(L, S - c0)
            ea = torch.exp(acs_ws[b, c, :, :Lc]).T                  # (Lc, H)
            U[b, c] = torch.einsum("lhp,ln->hpn", ea[..., None]
                                   * dy[b, c0:c0 + Lc], Cm[b, c0:c0 + Lc])
    # bwd_grec_kernel: g_ws[:, c] = G_{c+1}
    g_ws = torch.zeros_like(U)
    cur = dfinal.clone() if dfinal is not None else \
        torch.zeros((Bsz, H, P, N), dtype=ft)
    for c in reversed(range(nc)):
        Lc = min(L, S - c * L)
        g_ws[:, c] = cur
        cur = cur * torch.exp(acs_ws[:, c, :, Lc - 1])[..., None, None] \
            + U[:, c]
    dinit = cur

    dx = torch.zeros_like(x)
    ddtx, colpart, rpart, rowpart = (torch.zeros((Bsz, nc, H, L), dtype=ft)
                                     for _ in range(4))
    dBp = torch.zeros((Bsz, H, S, N), dtype=ft)
    dCp = torch.zeros((Bsz, H, S, N), dtype=ft)
    vis_s = torch.zeros((Bsz, nc, H, pad, pad), dtype=torch.int64)
    vis_l = torch.zeros_like(vis_s)
    for b in range(Bsz):
        for c in range(nc):
            c0 = c * L
            Lc = min(L, S - c0)
            Cc, Bc = rows(Cm, b, c0, Lc), rows(Bm, b, c0, Lc)
            xc, dyc, dtc = rows(x, b, c0, Lc), rows(dy, b, c0, Lc), \
                rows(dt, b, c0, Lc)
            acs = torch.zeros((pad, H), dtype=ft)
            acs[:Lc] = acs_ws[b, c, :, :Lc].T
            on_row = torch.arange(pad) < Lc

            def mask(li, si):
                on = (si[None, :] <= li[:, None]) & on_row[li][:, None]
                seg = acs[li][:, None, :] - acs[si][None, :, :]    # (l, s, H)
                return on, torch.exp(torch.where(on[..., None], seg,
                                                 -torch.inf))
            for h in range(H):
                G, prev = g_ws[b, c, h], st_ws[b, c, h]
                # bwd_s_kernel
                for st in range(nlt):
                    if st * T >= Lc:
                        continue
                    si = torch.arange(st * T, (st + 1) * T)
                    Bs = Bc[si]
                    dtx = dtc[si, h, None] * xc[si, h]
                    ds = torch.where(on_row[si], torch.exp(
                        acs[Lc - 1, h] - acs[si, h]), 0.0)
                    dd = ds[:, None] * (Bs @ G.T)
                    r = (dtx * dd).sum(-1)
                    dBh = ds[:, None] * (dtx @ G)
                    colE = torch.zeros(T, dtype=ft)
                    for lt in range(st, nlt):
                        if lt * T >= Lc:
                            continue
                        li = torch.arange(lt * T, (lt + 1) * T)
                        on, Lm = mask(li, si)
                        Lm = Lm[..., h]
                        dW = dyc[li, h] @ dtx.T
                        dCB = Lm * dW
                        cbt = cb[b, c, tri(lt, st)]
                        colE = colE + (cbt * dCB).sum(0)
                        dd = dd + (cbt * Lm).T @ dyc[li, h]
                        dBh = dBh + dCB.T @ Cc[li]
                        vis_s[b, c, h, lt * T:(lt + 1) * T,
                              st * T:(st + 1) * T] += on
                    n = min(T, Lc - st * T)
                    s0 = st * T
                    dx[b, c0 + s0:c0 + s0 + n, h] = \
                        dtc[si, h, None][:n] * dd[:n]
                    ddtx[b, c, h, s0:s0 + n] = (xc[si, h] * dd).sum(-1)[:n]
                    colpart[b, c, h, s0:s0 + n] = -(colE + r)[:n]
                    rpart[b, c, h, s0:s0 + n] = r[:n]
                    dBp[b, h, c0 + s0:c0 + s0 + n] = dBh[:n]
                # bwd_l_kernel
                for lt in range(nlt):
                    if lt * T >= Lc:
                        continue
                    li = torch.arange(lt * T, (lt + 1) * T)
                    ea = torch.where(on_row[li], torch.exp(acs[li, h]), 0.0)
                    dCh = ea[:, None] * (dyc[li, h] @ prev)
                    yoff = (Cc[li] * dCh).sum(-1)
                    rowE = torch.zeros(T, dtype=ft)
                    for st in range(lt + 1):
                        si = torch.arange(st * T, (st + 1) * T)
                        on, Lm = mask(li, si)
                        dtx = dtc[si, h, None] * xc[si, h]
                        dCB = Lm[..., h] * (dyc[li, h] @ dtx.T)
                        rowE = rowE + (cb[b, c, tri(lt, st)] * dCB).sum(1)
                        dCh = dCh + dCB @ Bc[si]
                        vis_l[b, c, h, lt * T:(lt + 1) * T,
                              st * T:(st + 1) * T] += on
                    n = min(T, Lc - lt * T)
                    l0 = lt * T
                    rowpart[b, c, h, l0:l0 + n] = (rowE + yoff)[:n]
                    dCp[b, h, c0 + l0:c0 + l0 + n] = dCh[:n]
    # bwd_combine_kernel
    ddt = torch.zeros_like(dt)
    dA_part = torch.zeros((Bsz, nc, H), dtype=f64)
    for b in range(Bsz):
        for c in range(nc):
            c0 = c * L
            Lc = min(L, S - c0)
            for h in range(H):
                dacs = rowpart[b, c, h, :Lc] + colpart[b, c, h, :Lc]
                last = rpart[b, c, h, :Lc].sum() + torch.exp(
                    acs_ws[b, c, h, Lc - 1]) * (g_ws[b, c, h]
                                                * st_ws[b, c, h]).sum()
                dacs[Lc - 1] = dacs[Lc - 1] + last
                da = torch.flip(torch.cumsum(torch.flip(dacs.double(), [0]),
                                             0), [0]).to(ft)
                dtl = dt[b, c0:c0 + Lc, h]
                ddt[b, c0:c0 + Lc, h] = A[h] * da + ddtx[b, c, h, :Lc]
                dA_part[b, c, h] = (dtl.double() * da.double()).sum()
    # bwd_reduce_kernel
    dB, dC = torch.zeros_like(Bm), torch.zeros_like(Cm)
    for h in range(H):
        dB = dB + dBp[:, h]
        dC = dC + dCp[:, h]
    dA = dA_part.sum((0, 1)).to(ft)
    return (dict(dx=dx, ddt=ddt, dA=dA, dB=dB, dC=dC, dinit=dinit),
            vis_s, vis_l)


def inputs(rng, B, S, H, P, N, init, dfin, bf16):
    """tests/test_kernels.py's distribution plus the cotangents; x, B, C
    and dy rounded to bf16 values when ``bf16``."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, Bm, Cm = f(B, S, H, P), f(B, S, N) * 0.5, f(B, S, N) * 0.5
    dt = np.log1p(np.exp(f(B, S, H)))
    A = -np.exp(f(H) * 0.3)
    s0 = f(B, H, P, N) if init else None
    dy = f(B, S, H, P)
    dfinal = f(B, H, P, N) if dfin else None
    if bf16:
        x, Bm, Cm, dy = (np.asarray(jnp.asarray(t).astype(jnp.bfloat16)
                                    .astype(jnp.float32))
                         for t in (x, Bm, Cm, dy))
    return x, dt, A, Bm, Cm, s0, dy, dfinal


def emulate(case, ft, split):
    """(emulated gradients, visit counts, plan, the numpy inputs)."""
    B, S, H, P, N, chunk, init, dfin = case
    rng = np.random.default_rng(11)
    arrs = inputs(rng, B, S, H, P, N, init, dfin, split)
    x, dt, A, Bm, Cm, s0, dy, dfinal = (
        None if a is None else torch.from_numpy(a.astype(ft)) for a in arrs)
    plan = scan_plan(S, chunk, P, N)
    acs_ws, st_ws = saved_workspaces(x, dt, A, Bm, Cm, s0, plan, split)
    got, vis_s, vis_l = bwd_passes(x, dt, A, Bm, Cm, dy, dfinal, acs_ws,
                                   st_ws, plan)
    return got, (vis_s, vis_l), plan, arrs


def recurrence(x, dt, A, Bm, Cm, init):
    """The scan's definition, one position at a time: state = exp(dt A)
    state + dt x Bᵀ, y = state C (differentiable, in the inputs' dtype)."""
    B, S, H, P = x.shape
    st = torch.zeros((B, H, P, Bm.shape[-1]), dtype=x.dtype) \
        if init is None else init
    ys = []
    for t in range(S):
        st = st * torch.exp(dt[:, t] * A)[..., None, None] + \
            (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", st, Cm[:, t]))
    return torch.stack(ys, 1), st


def autograd_f64(arrs):
    """torch.autograd of the scan's definition in float64 (the plain
    version, ``kernels/ref.py:ssd_scan_ref``, computes in fp32 whatever it
    is given; ``test_plain_backward_matches_jax_vjp`` holds its backward
    to the JAX oracle's)."""
    x, dt, A, Bm, Cm, s0, dy, dfinal = (
        None if a is None else torch.from_numpy(a.astype(np.float64))
        for a in arrs)
    ins = [t.requires_grad_() for t in (x, dt, A, Bm, Cm)]
    if s0 is not None:
        ins.append(s0.requires_grad_())
    y, sf = recurrence(*ins[:5], s0)
    outs, cots = [y], [dy]
    if dfinal is not None:
        outs.append(sf)
        cots.append(dfinal)
    g = torch.autograd.grad(outs, ins, cots)
    return dict(zip(GRADS + ("dinit",), g))


def jax_vjp(arrs, chunk, io):
    """jax.vjp of the JAX oracle; x, B, C and dy in ``io``."""
    x, dt, A, Bm, Cm, s0, dy, dfinal = arrs
    j = lambda a, d="float32": None if a is None else jnp.asarray(a, d)
    has_init = s0 is not None

    def f(x, dt, A, Bm, Cm, *s):
        return jref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                 init_state=s[0] if s else None,
                                 return_state=True)
    prim = [j(x, io), j(dt), j(A), j(Bm, io), j(Cm, io)] + \
        ([j(s0)] if has_init else [])
    (y, sf), pull = jax.vjp(f, *prim)
    cot_sf = j(dfinal) if dfinal is not None else jnp.zeros_like(sf)
    g = pull((j(dy, io), cot_sf))
    return {k: np.asarray(v.astype(jnp.float32))
            for k, v in zip(GRADS + ("dinit",), g)}


def dA_scale(x, dt, A, dx, ddt) -> float:
    """The scale dA is held to: max over heads of Σ_{b,s} |dt d a|, the
    sum of the absolute values of its terms. d a comes from the
    reference's own gradients, d a = (ddt - Σ_p x dx / dt) / A. dA sums
    B·S terms that cancel, so an fp32 dA's error (the plain version's and
    the JAX oracle's included) is a share of that sum, not of the result:
    held to its largest |dA|, two fp32 orders of the sum differ by more
    than 2e-5 on some of these cases."""
    x, dt, A, dx, ddt = (np.asarray(a, np.float64)
                         for a in (x, dt, A, dx, ddt))
    terms = np.abs(dt * ddt - (x * dx).sum(-1)).sum((0, 1)) / np.abs(A)
    return float(terms.max())


def assert_scaled(name, got, want, tol, scale=None):
    """Each gradient within ``tol`` of its own largest |g| (a sum over
    rows or heads whose terms cancel is held to the scale of the whole),
    or of ``scale``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = scale or float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0,
                               err_msg=name)


def assert_grads(got, want, arrs, tol):
    """dx, ddt, dB, dC within ``tol`` of their largest |g|; dA within
    ``tol`` of ``dA_scale``."""
    for k in GRADS:
        scale = dA_scale(arrs[0], arrs[1], arrs[2], want["dx"],
                         want["ddt"]) if k == "dA" else None
        assert_scaled(k, got[k], want[k], tol, scale)


CASE_IDS = [f"B{c[0]}-S{c[1]}-H{c[2]}-P{c[3]}-N{c[4]}-chunk{c[5]}"
            f"{'-init' if c[6] else ''}{'-dfinal' if c[7] else ''}"
            for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_bwd_passes_match_autograd_in_float64(case):
    """The decomposition (tiles, masks, the reverse recurrence, the
    partials and their reductions, ragged chunks) with nothing rounded:
    float64 against autograd of the scan's float64 definition, to 1e-9; and
    every (l, s) pair on or below the diagonal of each chunk visited
    exactly once by each side, none above it or past the chunk."""
    got, (vis_s, vis_l), plan, arrs = emulate(case, np.float64, False)
    want = {k: v.detach() for k, v in autograd_f64(arrs).items()}
    for k in GRADS:
        assert_scaled(k, got[k], want[k], 1e-9)
    if case[6]:
        assert_scaled("dinit", got["dinit"], want["dinit"], 1e-9)
    S, L = case[1], plan.chunk
    for c in range(plan.chunks):
        Lc = min(L, S - c * L)
        i = torch.arange(vis_s.shape[-1])
        want_vis = ((i[None, :] <= i[:, None]) & (i[:, None] < Lc)).long()
        assert torch.equal(vis_s[:, c], want_vis.expand_as(vis_s[:, c]))
        assert torch.equal(vis_l[:, c], want_vis.expand_as(vis_l[:, c]))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_bwd_passes_match_jax_vjp_fp32(case):
    """In fp32 against jax.vjp of the JAX oracle on the same inputs and
    cotangents: each gradient within 2e-5 of its largest |g| (dA of
    ``dA_scale``), d init_state 1e-3."""
    got, _, _, arrs = emulate(case, np.float32, False)
    want = jax_vjp(arrs, case[5], "float32")
    assert_grads(got, want, arrs, F32_TOL)
    if case[6]:
        assert_scaled("dinit", got["dinit"], want["dinit"], STATE_TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[6]],
                         ids=[CASE_IDS[0], CASE_IDS[2], CASE_IDS[6]])
def test_bwd_passes_bf16_match_jax_vjp(case):
    """The bf16 route (the tensor-core kernels, emulated by
    ``tests/test_torch_ssd_bwd_tc.py``) on these cases: x, B, C and dy
    bf16 values, every fp32 operand split into bf16 hi + lo, dx, dB, dC
    rounded to bf16, against the JAX oracle on the same bf16 inputs."""
    from test_torch_ssd_bwd_tc import emulate as tc_emulate

    got, _, _, _, arrs = tc_emulate(case, np.float32, True)
    for k in ("dx", "dB", "dC"):
        got[k] = got[k].to(torch.bfloat16).float()
    want = jax_vjp(arrs, case[5], "bfloat16")
    assert_grads(got, want, arrs, BF16_TOL)
    if case[6]:
        assert_scaled("dinit", got["dinit"], want["dinit"], STATE_TOL)


@pytest.mark.parametrize("P", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("N", [16, 20, 64, 128])
@pytest.mark.parametrize("chunk", [8, 128, 256])
def test_bwd_smem_fits_the_model_shapes(P, N, chunk):
    """The backward's kernels fit a block's shared memory at every head
    dim the forward takes and N up to 128: the fp32 route's five and the
    bf16 route's two (the fused mma.sync pass, with its per-position
    arrays in shared memory at these chunks, and U_c); the fused pass
    leaves room for two CTAs a SM at both training shapes."""
    smem = bwd_smem_bytes(P, N, chunk)
    assert set(smem) == {"cb", "dstate", "s", "l", "combine", "mma",
                         "mma_long", "mma_state"}
    assert max(smem.values()) <= SMEM_LIMIT
    plan = scan_plan(chunk, chunk, P, N)
    assert not BwdPlan(plan, tc=True).long_chunk(P, N)
    for tc, keys in ((False, {"cb", "dstate", "s", "l", "combine"}),
                     (True, {"mma", "mma_state"})):
        assert BwdPlan(plan, tc=tc).smem(P, N) == {k: smem[k] for k in keys}
    if (P, chunk) == (64, 128) and N in (64, 128):
        # two CTAs and their 1 KB reserves in the SM's 228 KB
        assert 2 * (smem["mma"] + 1024) <= 228 * 1024


def forward_chunk_limit(P: int, N: int, bf16: bool) -> int:
    """The longest chunk the forward's kernels take at (P, N) (one chunk
    of S = chunk), by bisection on their shared memory."""
    def fits(chunk):
        plan = scan_plan(chunk, chunk, P, N)
        need = max(plan.smem().values()) if bf16 else \
            fwd_smem_bytes(P, N, plan.chunk)
        return need <= SMEM_LIMIT
    lo, hi = 1, 1 << 17
    assert not fits(hi)
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("N", [16, 64, 128])
@pytest.mark.parametrize("P", [8, 16, 32, 64, 128])
def test_bwd_takes_every_chunk_the_forward_takes(P, N, bf16):
    """At the longest chunk the forward takes, the backward's kernels fit
    shared memory too, so a training call that passes the forward does
    not raise in the backward. The bf16 fused pass moves its
    per-position arrays to a workspace past its own limit (at P 128 / N
    128 a chunk of 5,120, against the forward's 13,824)."""
    chunk = forward_chunk_limit(P, N, bf16)
    assert chunk >= 6000
    bplan = BwdPlan(scan_plan(chunk, chunk, P, N), tc=bf16)
    assert max(bplan.smem(P, N).values()) <= SMEM_LIMIT
    if bf16 and (P, N) == (128, 128):
        assert bplan.long_chunk(P, N)
        assert bwd_smem_bytes(P, N, 5120)["mma"] <= SMEM_LIMIT < \
            bwd_smem_bytes(P, N, 5121)["mma"]


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[5]],
                         ids=[CASE_IDS[0], CASE_IDS[1], CASE_IDS[5]])
def test_plain_backward_matches_jax_vjp(case):
    """The wrapper's CPU route (``ssd_scan_bwd`` on CPU tensors: autograd
    of the plain version, the card's yardstick) and ``ops.ssd_scan`` under
    autograd on the CPU, against jax.vjp of the JAX oracle."""
    _, _, _, arrs = emulate(case, np.float32, False)
    x, dt, A, Bm, Cm, s0, dy, dfinal = (
        None if a is None else torch.from_numpy(a) for a in arrs)
    chunk = case[5]
    got = dict(zip(GRADS + ("dinit",), ssd_scan_bwd(
        dy, x, dt, A, Bm, Cm, chunk=chunk, init_state=s0, dfinal=dfinal)))
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    init = None if s0 is None else s0.clone().requires_grad_()
    y, sf = ops.ssd_scan(*ins, chunk=chunk, init_state=init,
                         return_state=True)
    loss = (y * dy).sum() + ((sf * dfinal).sum() if dfinal is not None
                             else 0.0)
    loss.backward()
    via_ops = {k: t.grad for k, t in zip(GRADS, ins)}
    want = jax_vjp(arrs, chunk, "float32")
    for g in (got, via_ops):
        assert_grads(g, want, arrs, F32_TOL)
    if s0 is None:
        assert got["dinit"] is None
    else:
        assert_scaled("dinit", got["dinit"], want["dinit"], STATE_TOL)
        assert_scaled("dinit", init.grad, want["dinit"], STATE_TOL)


@pytest.mark.parametrize("S,chunk,H,P,N", [(128, 128, 80, 64, 64),
                                           (128, 128, 48, 64, 128),
                                           (512, 256, 80, 64, 64),
                                           (500, 256, 48, 64, 128),
                                           (33, 8, 2, 16, 64),
                                           (6000, 6000, 2, 128, 128)])
def test_bwd_plan_ctas_and_workspaces(S, chunk, H, P, N):
    """The backward's CTAs per kernel and its workspaces. fp32: at zamba2's
    training shape (8 x 128, 80 heads, one chunk of two 64-row tiles) the
    s and l kernels run 1,280 CTAs each. bf16: one fused CTA per (row,
    chunk, head); with one chunk and neither an init state nor a final
    cotangent no U_c or recurrence CTA runs (G is zero) and no G workspace
    exists; U_0 runs only with an init state. The heads' dB and dC sum in
    clusters of up to 8, so the partials left in device memory are
    (B, H / cluster, S, N): an eighth of the fp32 route's per-head pair at
    both training shapes. The fused pass's per-position arrays get a
    workspace only past its shared memory (one chunk of 6,000 at P 128 /
    N 128). Every workspace is disjoint and 64-float aligned."""
    B = 8
    plan = scan_plan(S, chunk, P, N)
    p = plan
    for init, dfin in ((False, False), (True, False), (False, True),
                       (True, True)):
        for tc in (False, True):
            bplan = BwdPlan(plan, tc=tc, init=init, dfinal=dfin)
            ctas = bplan.ctas(B, S, H, P, N)
            shapes = bplan.workspace_shapes(B, S, H, P, N)
            offs, floats = bplan.workspace_offsets(B, S, H, P, N)
            sizes = [int(np.prod(s)) for s in shapes.values()]
            assert all(o % 64 == 0 for o in offs)
            ends = [o + n for o, n in zip(offs, sizes)]
            assert all(e <= o for e, o in zip(ends, offs[1:]))
            assert ends[-1] <= floats
            if not tc:
                assert ctas["s"] == ctas["l"] == p.l_tiles * p.chunks * H * B
                assert ctas["combine"] == ctas["dstate"] == p.chunks * H * B
                if (S, H) == (128, 80):
                    assert (p.chunks, p.l_tiles, ctas["s"]) == (1, 2, 1280)
                per_head = 2 * int(np.prod(shapes["dbp"]))
                continue
            assert ctas["mma"] == p.chunks * H * B
            zero_state = p.chunks == 1 and not (init or dfin)
            assert ("grec" in ctas) == ("g" in shapes) == (not zero_state)
            assert ctas.get("mma_state", 0) == \
                (p.chunks - (0 if init else 1)) * H * B
            if zero_state:
                assert list(ctas) == ["mma", "reduce"]
            hc = bwd_cluster(H)
            assert shapes["dbp"] == shapes["dcp"] == \
                (B, H // hc, S, -(-N // 4) * 4)
            assert ("pend" in shapes) == (p.l_tiles >= 3)
            assert ("pos" in shapes) == bplan.long_chunk(P, N) == (S == 6000)
            if S == 6000:
                assert shapes["pos"] == (B, 1, H, 6, 94 * TILE)
            left = 2 * int(np.prod(shapes["dbp"]))
            assert left * hc == per_head
            if (S, H) in ((128, 80), (128, 48)):
                assert hc == 8 and ctas["mma"] == (640 if H == 80 else 384)
