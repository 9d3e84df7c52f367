"""The bf16 SSD scan's three chunk-parallel passes, on the CPU.

The CUDA kernels (``kernels/csrc/ssd_scan.cu``) run only on the card, so
this file emulates them in torch on their own tiling, from
``scan_plan``: pass A computes C Bᵀ once per (row, chunk) in the
lower-triangular 64 x 64 tiles, a_cs by an fp64 cumsum rounded once, and
each head's chunk state ``xᵀ (dt exp(a_cs[-1] - a_cs) B)``; pass B walks
the chunks in order and replaces each chunk state with the state entering
the chunk; pass C builds each 64-row y tile as ``(C prevᵀ) exp(a_cs[l])``
plus ``G' x`` over the s tiles on or below it. On the diagonal tile
``G' = (C Bᵀ) o exp(a_cs[l] - a_cs[s]) o dt[s]``, masked before exp;
below it the decay factors through the tile's first row l0, ``G' =
exp(a_cs[l] - a_cs[l0]) (C Bᵀ) exp(a_cs[l0] - a_cs[s]) dt[s]``.

The passes run three ways: in float64 against the scan's definition, a
float64 recurrence; in fp32 against the JAX oracle
``repro.kernels.ref.ssd_scan_ref``; and with the kernels' rounding (x, B
and C bf16 values, every fp32 operand of a product — G', the state
entering the chunk, dt decay B — split into bf16 hi + lo where the
kernels split it) against the JAX oracle on the same bf16 inputs. Inputs
are drawn with numpy from a seed.

Tolerances: float64 1e-9; fp32 2e-5 (tests/test_kernels.py), the final
state 1e-3 as that file holds it; with the bf16 split y at 5e-2 (y is
bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ssd_scan import SMEM_LIMIT, TILE, scan_plan

CASES = [  # B, S, H, P, N, chunk, init
    (2, 100, 3, 16, 16, 32, True),       # ragged S + init state
    (2, 33, 4, 64, 32, 8, False),        # chunk 8
    (1, 5, 2, 16, 16, 5, False),         # chunk = S < 8
    (1, 300, 3, 64, 64, 256, True),      # chunk 256, N 64 (zamba2), init
    (1, 300, 2, 64, 128, 256, False),    # chunk 256, N 128 (mamba2)
    (1, 1024, 2, 32, 64, 256, False),    # four chunks
    (1, 200, 2, 8, 20, 128, False),      # P 8 and N 20, padded to 16 / 32
]
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
STATE_TOL = dict(atol=1e-3, rtol=1e-3)


def hi_lo(v: torch.Tensor) -> torch.Tensor:
    """v as bf16 hi + lo summed in fp32 (exact: the two carry ~16 bits)."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def passes(x, dt, A, Bm, Cm, chunk, init, split):
    """The kernels' three passes on CPU tensors of one float dtype, in that
    dtype; -> (y, final state, the plan)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    ft = x.dtype
    plan = scan_plan(S, chunk, P, N)
    L, nc, T = plan.chunk, plan.chunks, TILE
    rnd = hi_lo if split else (lambda v: v)
    shapes = plan.workspace_shapes(Bsz, H, P, N)
    cb_ws = torch.zeros(shapes["cb"], dtype=ft)
    acs_ws = torch.zeros(shapes["acs"], dtype=ft)
    st_ws = torch.zeros(shapes["state"], dtype=ft)
    pad = plan.l_tiles * T

    def rows(m, b, c0, Lc):           # a chunk's rows, zero past Lc
        out = torch.zeros((pad,) + tuple(m.shape[2:]), dtype=ft)
        out[:Lc] = m[b, c0:c0 + Lc]
        return out

    # pass A
    for b in range(Bsz):
        for c in range(nc):
            c0 = c * L
            Lc = min(L, S - c0)
            Cc, Bc = rows(Cm, b, c0, Lc), rows(Bm, b, c0, Lc)
            for lt in range(plan.l_tiles):
                for st in range(lt + 1):
                    if lt * T < Lc:
                        cb_ws[b, c, lt * (lt + 1) // 2 + st] = \
                            Cc[lt * T:(lt + 1) * T] @ Bc[st * T:(st + 1) * T].T
            a = dt[b, c0:c0 + Lc] * A                          # (Lc, H)
            acs = torch.cumsum(a.double(), 0).to(ft)           # rounded once
            acs_ws[b, c, :, :Lc] = acs.T
            fac = dt[b, c0:c0 + Lc] * torch.exp(acs[-1] - acs)  # (Lc, H)
            for h in range(H):
                W = rnd(fac[:, h, None] * Bc[:Lc])             # (Lc, N)
                st_ws[b, c, h] = x[b, c0:c0 + Lc, h].T @ W     # (P, N)
    # pass B
    cur = init.clone() if init is not None else \
        torch.zeros((Bsz, H, P, N), dtype=ft)
    for c in range(nc):
        Lc = min(L, S - c * L)
        decay = torch.exp(acs_ws[:, c, :, Lc - 1])             # (B, H)
        prev = cur
        cur = cur * decay[..., None, None] + st_ws[:, c]
        st_ws[:, c] = prev
    # pass C
    y = torch.zeros((Bsz, S, H, P), dtype=ft)
    for b in range(Bsz):
        for c in range(nc):
            c0 = c * L
            Lc = min(L, S - c0)
            Cc, xc = rows(Cm, b, c0, Lc), rows(x, b, c0, Lc)
            dtc = rows(dt, b, c0, Lc)                           # (pad, H)
            acs = torch.zeros((pad, H), dtype=ft)
            acs[:Lc] = acs_ws[b, c, :, :Lc].T
            for lt in range(plan.l_tiles):
                l0 = lt * T
                if l0 >= Lc:
                    continue
                li = torch.arange(l0, l0 + T)
                for h in range(H):
                    Y = (Cc[li] @ rnd(st_ws[b, c, h]).T) \
                        * torch.exp(acs[li, h])[:, None]
                    on_l = (li < Lc)[:, None]
                    for st in range(lt + 1):
                        si = torch.arange(st * T, (st + 1) * T)
                        cbt = cb_ws[b, c, lt * (lt + 1) // 2 + st]
                        if st < lt:     # decay factored through row l0
                            u = torch.exp(acs[li, h] - acs[l0, h])[:, None]
                            v = torch.exp(acs[l0, h] - acs[si, h]) * dtc[si, h]
                            G = torch.where(on_l, cbt * v[None, :] * u, 0.0)
                        else:
                            seg = acs[li, h][:, None] - acs[si, h][None, :]
                            on = (si[None, :] <= li[:, None]) & on_l
                            lmask = torch.exp(torch.where(on, seg, -torch.inf))
                            G = cbt * lmask * dtc[si, h][None, :]
                        Y = Y + rnd(G) @ xc[si, h]
                    n = min(T, Lc - l0)
                    y[b, c0 + l0:c0 + l0 + n, h] = Y[:n]
    return y, cur, plan


def inputs(rng, B, S, H, P, N, init, dtype):
    """tests/test_kernels.py's distribution; x, B, C as ``dtype`` values."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, Bm, Cm = f(B, S, H, P), f(B, S, N) * 0.5, f(B, S, N) * 0.5
    dt = np.log1p(np.exp(f(B, S, H)))
    A = -np.exp(f(H) * 0.3)
    s0 = f(B, H, P, N) if init else None
    if dtype == "bfloat16":
        x, Bm, Cm = (np.asarray(jnp.asarray(t).astype(jnp.bfloat16)
                                .astype(jnp.float32)) for t in (x, Bm, Cm))
    return x, dt, A, Bm, Cm, s0


def recurrence(x, dt, A, Bm, Cm, init):
    """The scan's definition, one position at a time, in float64:
    state = exp(dt A) state + dt x Bᵀ, y = state C."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a).double()
                        for a in (x, dt, A, Bm, Cm))
    B, S, H, P = x.shape
    st = torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float64) \
        if init is None else torch.from_numpy(init).double()
    y = torch.zeros((B, S, H, P), dtype=torch.float64)
    for t in range(S):
        st = st * torch.exp(dt[:, t] * A)[..., None, None] + \
            (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :]
        y[:, t] = torch.einsum("bhpn,bn->bhp", st, Cm[:, t])
    return y.numpy(), st.numpy()


def run(case, mode):
    """(passes' y, final state, plan; the reference's y, final state) for
    one case. ``mode``: "float64" the passes in float64 against the
    float64 recurrence (the JAX oracle computes in fp32 whatever it is
    given); "float32" the passes in fp32 against the JAX oracle; "bf16"
    the passes with the kernels' bf16 split against the JAX oracle on the
    same bf16 x, B, C."""
    B, S, H, P, N, chunk, init = case
    rng = np.random.default_rng(7)
    x, dt, A, Bm, Cm, s0 = inputs(rng, B, S, H, P, N, init,
                                  "bfloat16" if mode == "bf16" else "float32")
    ft = np.float64 if mode == "float64" else np.float32
    t = lambda a: None if a is None else torch.from_numpy(a.astype(ft))
    y, sf, plan = passes(t(x), t(dt), t(A), t(Bm), t(Cm), chunk, t(s0),
                         mode == "bf16")
    if mode == "float64":
        return (y.numpy(), sf.numpy(), plan) + recurrence(x, dt, A, Bm, Cm,
                                                         s0)
    io = "bfloat16" if mode == "bf16" else "float32"
    j = lambda a, d="float32": None if a is None else jnp.asarray(a, d)
    yr, sr = jref.ssd_scan_ref(j(x, io), j(dt), j(A), j(Bm, io), j(Cm, io),
                               chunk=chunk, init_state=j(s0),
                               return_state=True)
    if mode == "bf16":                # the kernel stores y in x's dtype
        y = y.to(torch.bfloat16).float()
    return (y.numpy(), sf.numpy(), plan, np.asarray(yr.astype(jnp.float32)),
            np.asarray(sr))


@pytest.mark.parametrize("B,S,H,P,N,chunk,init", CASES)
def test_chunk_passes_match_the_recurrence_in_float64(B, S, H, P, N, chunk,
                                                      init):
    """The decomposition (tiles, masks, C Bᵀ once per chunk, state passing,
    padding) with no operand rounded: float64 against the scan's
    definition, to 1e-9."""
    y, sf, plan, yr, sr = run((B, S, H, P, N, chunk, init), "float64")
    np.testing.assert_allclose(y, yr, atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(sf, sr, atol=1e-9, rtol=1e-9)
    assert plan.chunks * plan.chunk >= S > (plan.chunks - 1) * plan.chunk


@pytest.mark.parametrize("B,S,H,P,N,chunk,init",
                         [c for c in CASES if c[5] <= 128])
def test_chunk_passes_match_jax_oracle_fp32(B, S, H, P, N, chunk, init):
    """In fp32, at chunks up to 128. At chunk 256, |a_cs| reaches ~200,
    where an fp32 ulp is 1.5e-5, and no fp32 order of the sums stays within
    2e-5 of another: the plain version (``kernels/ref.py``) and the JAX
    oracle differ by up to 2.7e-4 there. The card holds each kernel to the
    plain version, which rounds a_cs at the kernels' point."""
    y, sf, _, yr, sr = run((B, S, H, P, N, chunk, init), "float32")
    np.testing.assert_allclose(y, yr, **F32_TOL)
    np.testing.assert_allclose(sf, sr, **STATE_TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk,init", CASES)
def test_chunk_passes_with_bf16_split_match_jax_oracle(B, S, H, P, N, chunk,
                                                       init):
    """The kernels' rounding: x, B and C bf16, every fp32 operand of a
    product split into bf16 hi + lo where the kernels split it."""
    y, sf, _, yr, sr = run((B, S, H, P, N, chunk, init), "bf16")
    np.testing.assert_allclose(y, yr, **BF16_TOL)
    np.testing.assert_allclose(sf, sr, **STATE_TOL)


def test_split_keeps_sixteen_bits():
    """hi + lo is within 2^-16 of the fp32 value, where bf16 alone is
    within 2^-8: the split is what keeps the fp32 operands' accuracy."""
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32))
    rel = lambda a: float(((a - v).abs() / v.abs()).max())
    assert rel(hi_lo(v)) < 2.0 ** -16 < 2.0 ** -9 < rel(v.to(torch.bfloat16)
                                                          .float())


@pytest.mark.parametrize("S", [1, 5, 64, 65, 257, 500, 1024, 4096])
@pytest.mark.parametrize("chunk", [1, 8, 100, 128, 256])
@pytest.mark.parametrize("P,N", [(8, 16), (64, 64), (64, 128), (128, 20)])
def test_scan_plan_covers_the_scan(S, chunk, P, N):
    plan = scan_plan(S, chunk, P, N)
    assert plan.chunk == min(chunk, S)
    assert (plan.chunks - 1) * plan.chunk < S <= plan.chunks * plan.chunk
    assert (plan.l_tiles - 1) * TILE < plan.chunk <= plan.l_tiles * TILE
    assert plan.cb_tiles == plan.l_tiles * (plan.l_tiles + 1) // 2
    assert plan.n_pad % 16 == 0 and N <= plan.n_pad < N + 16
    assert plan.p_pad == max(P, 16)
    assert plan.n_blocks * 64 >= plan.n_pad > (plan.n_blocks - 1) * 64
    offs, floats = plan.workspace_offsets(2, 3, P, N)
    sizes = [int(np.prod(s)) for s in plan.workspace_shapes(2, 3, P, N)
             .values()]
    assert all(o % 64 == 0 for o in offs)
    ends = [o + n for o, n in zip(offs, sizes)]
    assert all(e <= o for e, o in zip(ends, offs[1:])) and ends[-1] <= floats
    # the bf16 kernels take every shape the fp32 kernel takes
    if tssd.smem_bytes(P, N, chunk) <= SMEM_LIMIT:
        assert max(plan.smem().values()) <= SMEM_LIMIT


def test_scan_plan_at_the_serving_shapes():
    """A 500-token prompt at chunk 256: 2 chunks of 4 l tiles, 10 C Bᵀ
    tiles per chunk; pass C runs 640 CTAs for zamba2-2.7b (80 heads) and
    384 for mamba2-780m (48), against B x H = 80 and 48 blocks of the fp32
    design; both fit shared memory."""
    for arch, out_ctas in (("zamba2-2.7b", 640), ("mamba2-780m", 384)):
        cfg = get_config(arch)
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        plan = scan_plan(500, cfg.ssm_chunk, P, N)
        assert (plan.chunk, plan.chunks, plan.l_tiles, plan.cb_tiles) == \
            (256, 2, 4, 10)
        ctas = plan.ctas(1, H, P, N)
        assert ctas["out"] == out_ctas > H
        assert ctas["chunk"] == 2 * (10 + H * plan.n_blocks)
        assert max(plan.smem().values()) <= SMEM_LIMIT
        # a 128-token prompt runs at chunk 128: one chunk of 2 l tiles
        assert scan_plan(128, min(cfg.ssm_chunk, 128), P, N).l_tiles == 2
