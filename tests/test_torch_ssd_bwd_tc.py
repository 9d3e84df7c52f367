"""The bf16 SSD backward on the tensor cores (``kernels/csrc/ssd_scan_bwd.cu``:
``bwd_mma_kernel`` and its helpers), emulated on the CPU on its own plan.

The CUDA kernels run only on the card, so this file replays the bf16
route of ``BwdPlan(tc=True)`` in torch, vectorised over rows and heads but
in the kernels' order:

* ``bwd_mma_state_kernel`` (only for the chunks after the first, and for
  chunk 0 only with an init state): U_c = (exp(a_cs) dy)ᵀ C, the fp32
  operand split into bf16 hi + lo;
* ``bwd_grec_kernel`` (only with more than one chunk, an init state or a
  final-state cotangent): the reverse recurrence, G_{c+1} per chunk;
* ``bwd_mma_kernel``, one CTA per (row, chunk, head): the s tiles in order
  and, for each, the l tiles on or below the diagonal, each (l, s) pair
  visited once. A pair computes C Bᵀ and dW = dt[s] ⟨dy[l], x[s]⟩ (exact
  bf16 operands, dt on the output column, no split), then dCB = L o dW and
  M = (C Bᵀ) o L; dCB and M are split into hi + lo for the l side (dC_h +=
  dCB B) and the s side (d dtx += Mᵀ dy, dB_h += dCBᵀ C). The chunk-state
  terms run only where the state is not zero: G's products when the chunk
  is not the last or a final-state cotangent was given (r[s] = ⟨B[s],
  dB_h[s]⟩ of those alone), the entering state's when the chunk is not
  the first or an init state was given; both split. E = (C Bᵀ) o dCB is
  never formed: rowsum E + ⟨dy, Y_off⟩ = ⟨C[l], dC_h[l]⟩ and colsum E + r
  = ⟨B[s], dB_h[s]⟩ are read off the finished tiles. A finished dB_h or
  dC_h tile is summed over the cluster's heads in rank order, the
  clusters' partials then in cluster order (``bwd_reduce_kernel``). d
  a_cs, its fp64 reverse cumsum, ddt and the fp64 partial dA end the CTA.

Checks: with nothing rounded (float64, no split) against torch.autograd of
the scan's quadratic form in float64, 1e-9; in fp32 without the split
against ``jax.vjp`` of ``repro.kernels.ref.ssd_scan_ref``, 2e-5; with bf16
x, B, C and dy, the kernels' splits and dx, dB, dC rounded to bf16, against
the JAX oracle on the same bf16 inputs, 5e-2. dA is held to
``dA_scale`` (the sum of its terms' |.|), d init_state to 1e-3. Each (l, s)
pair on or below the diagonal is visited exactly once, none above it.
Inputs come from numpy with a seed (``tests/test_torch_ssd_bwd.py``'s
distribution and helpers).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import (TILE, BwdPlan, bwd_cluster,
                                          scan_plan)
from test_torch_ssd_bwd import (BF16_TOL, F32_TOL, GRADS, STATE_TOL,
                                assert_grads, assert_scaled, hi_lo, inputs,
                                jax_vjp, saved_workspaces)

CASES = [  # B, S, H, P, N, chunk, init, final-state cotangent
    (8, 128, 80, 64, 64, 128, False, False),   # zamba2-2.7b training
    (8, 128, 48, 64, 128, 128, False, False),  # mamba2-780m training
    (1, 300, 3, 32, 64, 256, True, True),      # two chunks, ragged, both
    (2, 200, 4, 64, 64, 128, False, True),     # two chunks, final cotangent
    (2, 40, 6, 16, 128, 40, False, False),     # N 128, P 16, S < 64
    (1, 100, 5, 16, 20, 64, True, False),      # N 20, init only, cluster 5
    (1, 70, 11, 8, 16, 70, False, True),       # P 8, one chunk + dfinal, 11
]
CASE_IDS = [f"B{c[0]}-S{c[1]}-H{c[2]}-P{c[3]}-N{c[4]}-chunk{c[5]}"
            f"{'-init' if c[6] else ''}{'-dfinal' if c[7] else ''}"
            for c in CASES]


def tc_passes(x, dt, A, Bm, Cm, dy, dfinal, acs_ws, st_ws, plan, init,
              split):
    """The bf16 route's kernels on CPU tensors of one float dtype, in that
    dtype (d a's cumsum and dA's partials in fp64; ``split`` rounds each
    fp32 operand to bf16 hi + lo). -> (dict of gradients, visit counts
    per chunk (chunks, pad, pad), the kernels that ran)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    ft = x.dtype
    T, L, nc = TILE, plan.chunk, plan.chunks
    pad = plan.l_tiles * T
    rnd = hi_lo if split else (lambda v: v)
    bplan = BwdPlan(plan, tc=True, init=init, dfinal=dfinal is not None)
    c_lo, runs_grec = bplan.runs()
    ran = ["mma_state"] if nc > c_lo else []
    hc = bwd_cluster(H)

    def rows(m, c0, Lc):                # a chunk's rows, zero past Lc
        out = torch.zeros((Bsz, pad) + tuple(m.shape[2:]), dtype=ft)
        out[:, :Lc] = m[:, c0:c0 + Lc]
        return out

    # bwd_mma_state_kernel: U_c, written where the recurrence reads it
    g_ws = torch.zeros((Bsz, nc, H, P, N), dtype=ft)
    for c in range(c_lo, nc):
        c0 = c * L
        Lc = min(L, S - c0)
        ea = torch.exp(acs_ws[:, c, :, :Lc]).transpose(1, 2)   # (B, Lc, H)
        g_ws[:, c] = torch.einsum("blhp,bln->bhpn", rnd(
            ea[..., None] * dy[:, c0:c0 + Lc]), Cm[:, c0:c0 + Lc])
    # bwd_grec_kernel: g_ws[:, c] = G_{c+1}; d init_state = G_0
    dinit = None
    if runs_grec:
        ran.append("grec")
        cur = dfinal.clone() if dfinal is not None else \
            torch.zeros((Bsz, H, P, N), dtype=ft)
        for c in reversed(range(nc)):
            u = g_ws[:, c].clone()
            g_ws[:, c] = cur
            if c == 0 and not init:
                break
            Lc = min(L, S - c * L)
            cur = cur * torch.exp(acs_ws[:, c, :, Lc - 1])[..., None, None] \
                + u
        if init:
            dinit = cur
    ran += ["mma", "reduce"]

    # bwd_mma_kernel
    dx = torch.zeros_like(x)
    ddt = torch.zeros_like(dt)
    dBh = torch.zeros((Bsz, H, S, N), dtype=ft)   # the heads' tiles, as the
    dCh = torch.zeros((Bsz, H, S, N), dtype=ft)   # clusters' sums read them
    dA_part = torch.zeros((Bsz, nc, H), dtype=torch.float64)
    visits = torch.zeros((nc, pad, pad), dtype=torch.int64)
    for c in range(nc):
        c0 = c * L
        Lc = min(L, S - c0)
        nlt = -(-Lc // T)
        xc, dyc = rows(x, c0, Lc), rows(dy, c0, Lc)    # (B, pad, H, P)
        Bc, Cc = rows(Bm, c0, Lc), rows(Cm, c0, Lc)    # (B, pad, N)
        dts = rows(dt, c0, Lc).transpose(1, 2)         # (B, H, pad)
        acs = torch.zeros((Bsz, H, pad), dtype=ft)
        acs[..., :Lc] = acs_ws[:, c, :, :Lc]
        on_row = torch.arange(pad) < Lc
        has_g = c + 1 < nc or dfinal is not None
        has_prev = c > 0 or init
        G, prev = g_ws[:, c], st_ws[:, c]
        rowp, colp, rr, ddx = (torch.zeros((Bsz, H, pad), dtype=ft)
                               for _ in range(4))
        parked, dc, dc_lt = {}, None, -1
        for st in range(nlt):
            si = torch.arange(st * T, (st + 1) * T)
            xs = xc[:, si].transpose(1, 2)             # (B, H, 64, P)
            Bs = Bc[:, si]                             # (B, 64, N)
            dd = torch.zeros((Bsz, H, T, P), dtype=ft)
            dbh = torch.zeros((Bsz, H, T, N), dtype=ft)
            if has_g:
                ds = torch.where(on_row[si], torch.exp(
                    acs[..., Lc - 1:Lc] - acs[..., si]), 0.0)
                dd = ds[..., None] * torch.einsum("bsn,bhpn->bhsp", Bs,
                                                  rnd(G))
                dbh = (ds * dts[..., si])[..., None] * (xs @ rnd(G))
                rr[..., si] = (Bs[:, None] * dbh).sum(-1)
            for lt in range(st, nlt):
                li = torch.arange(lt * T, (lt + 1) * T)
                dys = dyc[:, li].transpose(1, 2)       # (B, H, 64, P)
                Cl = Cc[:, li]                         # (B, 64, N)
                if dc_lt != lt:   # carried while pairs share the l tile
                    if dc_lt >= 0:
                        parked[dc_lt] = dc
                    if st > 0:
                        dc = parked.pop(lt)
                    else:
                        dc = torch.zeros((Bsz, H, T, N), dtype=ft)
                        if has_prev:
                            ea = torch.where(on_row[li], torch.exp(
                                acs[..., li]), 0.0)
                            dc = ea[..., None] * (dys @ rnd(prev))
                    dc_lt = lt
                cb = Cl @ Bs.transpose(1, 2)           # (B, 64, 64)
                dW = (dys @ xs.transpose(2, 3)) * dts[..., None, si]
                on = (si[None, :] <= li[:, None]) & on_row[li][:, None]
                seg = acs[..., li, None] - acs[..., None, si]
                Lm = torch.exp(torch.where(on, seg, -torch.inf))
                dCB = Lm * dW
                M = cb[:, None] * Lm
                dc = dc + rnd(dCB) @ Bs[:, None]
                dd = dd + rnd(M).transpose(2, 3) @ dys
                dbh = dbh + rnd(dCB).transpose(2, 3) @ Cl[:, None]
                visits[c, lt * T:(lt + 1) * T, st * T:(st + 1) * T] += on
                if lt == st:      # l tile complete
                    n = min(T, Lc - lt * T)
                    dCh[:, :, c0 + lt * T:c0 + lt * T + n] = dc[:, :, :n]
                    rowp[..., li] = (Cl[:, None] * dc).sum(-1)
                    dc_lt = -1
            n = min(T, Lc - st * T)
            s0 = c0 + st * T
            dx[:, s0:s0 + n] = (dts[..., si, None] * dd)[:, :, :n] \
                .transpose(1, 2)
            ddx[..., si] = (xs * dd).sum(-1)
            colp[..., si] = (Bs[:, None] * dbh).sum(-1)
            dBh[:, :, s0:s0 + n] = dbh[:, :, :n]
        assert not parked and dc_lt == -1
        # d a_cs, the fp64 reverse cumsum, ddt, the partial dA
        last = rr[..., :Lc].double().sum(-1)
        if has_g and has_prev:
            last = last + torch.exp(acs[..., Lc - 1]).double() * (
                G.double() * prev.double()).sum((-1, -2))
        dacs = (rowp[..., :Lc] - colp[..., :Lc]).double()
        dacs[..., Lc - 1] += last
        da = torch.flip(torch.cumsum(torch.flip(dacs, [-1]), -1), [-1]) \
            .to(ft)
        ddt[:, c0:c0 + Lc] = (A[:, None] * da + ddx[..., :Lc]).transpose(1, 2)
        dA_part[:, c] = (dts[..., :Lc].double() * da.double()).sum(-1)
    # the heads' sum: in rank order inside a cluster, then cluster order
    dB, dC = torch.zeros_like(Bm), torch.zeros_like(Cm)
    for q in range(H // hc):
        pb, pc = dBh[:, q * hc], dCh[:, q * hc]
        for r in range(1, hc):
            pb, pc = pb + dBh[:, q * hc + r], pc + dCh[:, q * hc + r]
        dB, dC = dB + pb, dC + pc
    dA = dA_part.sum((0, 1)).to(ft)
    return (dict(dx=dx, ddt=ddt, dA=dA, dB=dB, dC=dC, dinit=dinit), visits,
            ran)


def emulate(case, ft, split):
    """(emulated gradients, visit counts, kernels run, plan, numpy
    inputs)."""
    B, S, H, P, N, chunk, init, dfin = case
    rng = np.random.default_rng(21)
    arrs = inputs(rng, B, S, H, P, N, init, dfin, split)
    x, dt, A, Bm, Cm, s0, dy, dfinal = (
        None if a is None else torch.from_numpy(a.astype(ft)) for a in arrs)
    plan = scan_plan(S, chunk, P, N)
    acs_ws, st_ws = saved_workspaces(x, dt, A, Bm, Cm, s0, plan, split)
    got, visits, ran = tc_passes(x, dt, A, Bm, Cm, dy, dfinal, acs_ws,
                                 st_ws, plan, init, split)
    return got, visits, ran, plan, arrs


def quadratic_f64(arrs):
    """torch.autograd of the scan's quadratic form in float64, over the
    whole sequence (no chunks): y[l] = sum_{s<=l} (C[l].B[s])
    exp(cs[l] - cs[s]) dt[s] x[s] + exp(cs[l]) init C[l], the final state
    exp(cs[-1]) init + sum_s exp(cs[-1] - cs[s]) dt[s] x[s] B[s]ᵀ, cs the
    cumsum of dt A; the mask is applied before exp."""
    x, dt, A, Bm, Cm, s0, dy, dfinal = (
        None if a is None else torch.from_numpy(a.astype(np.float64))
        for a in arrs)
    ins = [t.requires_grad_() for t in (x, dt, A, Bm, Cm)]
    if s0 is not None:
        ins.append(s0.requires_grad_())
    x, dt, A, Bm, Cm = ins[:5]
    S = x.shape[1]
    cs = torch.cumsum(dt * A, 1)                             # (B, S, H)
    i = torch.arange(S)
    on = i[None, :] <= i[:, None]                            # (l, s)
    seg = cs[:, :, None, :] - cs[:, None, :, :]              # (B, l, s, H)
    Lm = torch.exp(torch.where(on[None, :, :, None], seg, -torch.inf))
    cb = Cm @ Bm.transpose(1, 2)                             # (B, l, s)
    y = torch.einsum("bls,blsh,bsh,bshp->blhp", cb, Lm, dt, x)
    dec = torch.exp(cs[:, -1:] - cs)                         # (B, S, H)
    sf = torch.einsum("bsh,bshp,bsn->bhpn", dec * dt, x, Bm)
    if s0 is not None:
        y = y + torch.einsum("blh,bhpn,bln->blhp", torch.exp(cs), s0, Cm)
        sf = sf + torch.exp(cs[:, -1])[..., None, None] * s0
    outs, cots = [y], [dy]
    if dfinal is not None:
        outs.append(sf)
        cots.append(dfinal)
    g = torch.autograd.grad(outs, ins, cots)
    return dict(zip(GRADS + ("dinit",), g))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tc_passes_match_autograd_in_float64(case):
    """The tensor-core route's decomposition with nothing rounded (the
    skipped zero-state terms, the carried and parked dC tiles, the
    clusters' head sum, ragged chunks): float64 against autograd of the
    scan's float64 quadratic form, 1e-9; every (l, s) pair on or below the
    diagonal of each chunk visited exactly once, none above it or past
    the chunk."""
    got, visits, _, plan, arrs = emulate(case, np.float64, False)
    want = {k: v.detach() for k, v in quadratic_f64(arrs).items()}
    for k in GRADS:
        assert_scaled(k, got[k], want[k], 1e-9)
    if case[6]:
        assert_scaled("dinit", got["dinit"], want["dinit"], 1e-9)
    S, L = case[1], plan.chunk
    i = torch.arange(visits.shape[-1])
    for c in range(plan.chunks):
        Lc = min(L, S - c * L)
        want_vis = ((i[None, :] <= i[:, None]) & (i[:, None] < Lc)).long()
        assert torch.equal(visits[c], want_vis)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tc_passes_match_jax_vjp_fp32(case):
    """Without the split, in fp32, against jax.vjp of the JAX oracle on the
    same inputs: each gradient within 2e-5 of its largest |g| (dA of
    ``dA_scale``), d init_state 1e-3."""
    got, _, _, _, arrs = emulate(case, np.float32, False)
    want = jax_vjp(arrs, case[5], "float32")
    assert_grads(got, want, arrs, F32_TOL)
    if case[6]:
        assert_scaled("dinit", got["dinit"], want["dinit"], STATE_TOL)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tc_passes_bf16_match_jax_vjp(case):
    """The kernels' rounding: x, B, C and dy bf16 values, dW unsplit, every
    fp32 operand (dCB, M, G, the entering state, exp(a_cs) dy, the forward's
    chunk-state operand) split into bf16 hi + lo, dx, dB, dC rounded to
    bf16, against the JAX oracle on the same bf16 inputs, 5e-2."""
    got, _, _, _, arrs = emulate(case, np.float32, True)
    for k in ("dx", "dB", "dC"):
        got[k] = got[k].to(torch.bfloat16).float()
    want = jax_vjp(arrs, case[5], "bfloat16")
    assert_grads(got, want, arrs, BF16_TOL)
    if case[6]:
        assert_scaled("dinit", got["dinit"], want["dinit"], STATE_TOL)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tc_plan_skips_the_zero_state(case):
    """The kernels the emulation ran are the plan's: no U_c or recurrence
    with one chunk and neither an init state nor a final cotangent (the
    training shapes: the fused pass and the reduction alone), U_0 only with
    an init state."""
    B, S, H, P, N, chunk, init, dfin = case
    _, _, ran, plan, _ = emulate(case, np.float64, False)
    bplan = BwdPlan(plan, tc=True, init=init, dfinal=dfin)
    ctas = bplan.ctas(B, S, H, P, N)
    assert list(ctas) == ran
    p = bplan.plan
    if p.chunks == 1 and not (init or dfin):
        assert list(ctas) == ["mma", "reduce"]
    assert ctas["mma"] == B * p.chunks * H
    assert ctas.get("mma_state", 0) == \
        B * H * (p.chunks - (0 if init else 1))
