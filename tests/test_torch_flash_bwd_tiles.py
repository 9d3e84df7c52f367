"""The flash-attention backward kernels' tile plans, emulated on the CPU.

``csrc/flash_attention_bwd.cu`` runs two plans. bf16 (the tensor-core
kernels): a dq pass, one CTA per (64-query tile, column half, q head,
row), that computes the tile's D = rowsum(dO o O) and walks the 64-key
tiles from ``key_range``; then a dk/dv pass, one CTA per (64-key tile,
column half, q head, row), launched in clusters of ``group`` CTAs along
the q heads, that walks the 64-query tiles from ``query_range``, stages
its head's dK and dV, and has cluster rank r sum rows [r*ceil(64/group),
...) of the tile over the cluster's CTAs in rank (= head) order (a group
of one stores straight from registers). A head
dim above 128 splits the output columns between two CTAs (``kSplit``),
each computing S and dP in full. fp32 (the scalar kernels): 16-query /
32-key steps in the dq pass, 16-key / 32-query steps in the dk/dv pass,
per-head partials and a group sum in head order.

This file replays those loops in float64 with the kernels' tile sizes,
the same range arithmetic, the same mask and the same order of the GQA
sum, and holds the result to ``torch.autograd`` of
``kernels/ref.py:flash_attention_ref`` (whose logits are fp32: within
1e-5 of each gradient's max |g|, or of 1 where that is smaller: a window
of one makes dq and dk exactly 0). It also checks that each pass visits
every visible (query, key) pair exactly once per head and column half,
and that the cluster's ranks cover every row of a KV tile exactly once,
so a tile the ranges skip or visit twice shows here, before the card.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import MAX_BWD_GROUP, check_window
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models.attention import GLOBAL_WINDOW

TILE = 64
PLANS = {"bf16": dict(bq1=TILE, bk1=TILE, bk2=TILE, bq2=TILE, cluster=True),
         "fp32": dict(bq1=16, bk1=32, bk2=16, bq2=32, cluster=False)}


def key_range(S, causal, window, q0, q_last, bk):
    """flash_attention_bwd.cu:key_range."""
    hi = q_last + 1 if causal else S
    lo = max(0, q0 - window + 1) if window > 0 else 0
    return (min(lo, hi) // bk) * bk, hi


def query_range(S, causal, window, k0, k_last, bq):
    """flash_attention_bwd.cu:query_range."""
    lo = k0 if causal else 0
    hi = min(S, k_last + window) if window > 0 else S
    return (lo // bq) * bq, hi


def col_split(hd, plan):
    """BwdPlan::kSplit: the CTAs that share a tile's hd columns."""
    return 2 if plan["cluster"] and hd > 128 else 1


def rank_rows(group):
    """The rows of a KV tile that each cluster rank sums."""
    rows = -(-TILE // group)
    return [range(r * rows, min(TILE, (r + 1) * rows)) for r in range(group)]


def visible(S, causal, window, qpos, kpos):
    ok = (qpos[:, None] < S) & (kpos[None, :] < S)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def emulate(q, k, v, dout, causal, window, scale, plan):
    """(dq, dk, dv, visits of the dq pass, visits of the dk/dv pass,
    the mask, odd visit counts) of ``plan``."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    win = check_window(window)
    qs = q * scale
    pos = torch.arange(S)
    # the forward's outputs: O and the per-row log-sum-exp
    mask = visible(S, causal, win, pos, pos)
    kk = k.repeat_interleave(group, 2)
    vv = v.repeat_interleave(group, 2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs, kk).masked_fill(~mask,
                                                                 -1e30)
    lse = torch.logsumexp(logits, -1)                        # (B,Hq,S)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), vv)
    delta = (dout * o).sum(-1).permute(0, 2, 1)              # (B,Hq,S)

    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    splits = col_split(hd, plan)
    hdc = hd // splits
    seen_q = torch.zeros((B, Hq, S, S), dtype=torch.int64)
    seen_kv = torch.zeros_like(seen_q)

    def tile(b, h, hk, rows, keys):
        qp, kp = pos[rows], pos[keys]
        m = visible(S, causal, win, qp, kp)
        s = qs[b, rows, h] @ k[b, keys, hk].T
        p = torch.where(m, torch.exp(s - lse[b, h, rows][:, None]), 0.0)
        dp = dout[b, rows, h] @ v[b, keys, hk].T
        ds = torch.where(m, p * (dp - delta[b, h, rows][:, None]), 0.0)
        return m, p, ds

    # each q head's dK and dV: per-head partials (fp32) or the staging
    # tile of the head's CTA in the cluster (bf16)
    part_k = torch.zeros((B, S, Hq, hd), dtype=q.dtype)
    part_v = torch.zeros_like(part_k)
    for b in range(B):
        for h in range(Hq):
            hk = h // group
            for half in range(splits):
                cols = slice(half * hdc, (half + 1) * hdc)
                for q0 in range(0, S, plan["bq1"]):
                    rows = slice(q0, min(q0 + plan["bq1"], S))
                    start, hi = key_range(S, causal, win, q0, rows.stop - 1,
                                          plan["bk1"])
                    for k0 in range(start, hi, plan["bk1"]):
                        keys = slice(k0, min(k0 + plan["bk1"], S))
                        m, _, ds = tile(b, h, hk, rows, keys)
                        seen_q[b, h, rows, keys] += m.long()
                        dq[b, rows, h, cols] += ds @ k[b, keys, hk, cols]
                for k0 in range(0, S, plan["bk2"]):
                    keys = slice(k0, min(k0 + plan["bk2"], S))
                    start, hi = query_range(S, causal, win, k0,
                                            keys.stop - 1, plan["bq2"])
                    for q0 in range(start, hi, plan["bq2"]):
                        rows = slice(q0, min(q0 + plan["bq2"], S))
                        m, p, ds = tile(b, h, hk, rows, keys)
                        seen_kv[b, h, rows, keys] += m.long()
                        part_v[b, keys, h, cols] += p.T @ dout[b, rows, h,
                                                               cols]
                        part_k[b, keys, h, cols] += ds.T @ qs[b, rows, h,
                                                              cols]
    if plan["cluster"]:
        # one cluster per (KV tile, column half, KV head, row); rank r sums
        # its rows over the cluster's CTAs in rank order
        covered = torch.zeros(TILE, dtype=torch.int64)
        for r, rr in enumerate(rank_rows(group)):
            covered[list(rr)] += 1
            for k0 in range(0, S, TILE):
                kp = [k0 + i for i in rr if k0 + i < S]
                for hk in range(Hkv):
                    for g in range(group):
                        dk[:, kp, hk] += part_k[:, kp, hk * group + g]
                        dv[:, kp, hk] += part_v[:, kp, hk * group + g]
        assert torch.equal(covered, torch.ones_like(covered))
    else:
        for hk in range(Hkv):         # the group's partials, in head order
            for h in range(hk * group, hk * group + group):
                dk[:, :, hk] += part_k[:, :, h]
                dv[:, :, hk] += part_v[:, :, h]
    return (dq * scale, dk, dv, seen_q // splits, seen_kv // splits, mask,
            seen_q % splits + seen_kv % splits)


CASES = [  # B, S, Hq, Hkv, hd, causal, window
    (1, 100, 8, 1, 16, True, None),        # GQA group 8, ragged last tile
    (2, 130, 4, 2, 32, True, 40),          # a window across tile edges
    (1, 97, 2, 2, 16, False, None),        # no mask but the ragged edge
    (1, 90, 4, 4, 16, False, 20),          # a window without causality
    (1, 70, 4, 2, 16, True, GLOBAL_WINDOW),    # the "no window" sentinel
    (1, 160, 2, 1, 16, True, 1),           # a window of one: the diagonal
    (1, 140, 12, 2, 16, True, None),       # a cluster of 6 (dbrx, nemotron)
    (1, 150, 2, 1, 256, False, 70),        # hd 256: two column halves
]


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_tile_plan_matches_autograd_of_the_oracle(case, plan):
    B, S, Hq, Hkv, hd, causal, window = case
    gen = torch.Generator().manual_seed(0)
    q, dout = (torch.randn((B, S, Hq, hd), generator=gen,
                           dtype=torch.float64) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, hd), generator=gen, dtype=torch.float64)
            for _ in range(2))
    scale = hd ** -0.5
    dq, dk, dv, seen_q, seen_kv, mask, odd = emulate(
        q, k, v, dout, causal, window, scale, PLANS[plan])
    # every visible pair exactly once per head and column half in each
    # pass, nothing else
    want = mask.long().expand_as(seen_q)
    assert not odd.any()
    assert torch.equal(seen_q, want)
    assert torch.equal(seen_kv, want)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_ref(*ins, causal=causal, window=window, scale=scale)
    grads = torch.autograd.grad(out, ins, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        err = float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                   1.0)
        assert err < 1e-5, f"{name}: {err:.3e}"


@pytest.mark.parametrize("group", range(1, MAX_BWD_GROUP + 1))
def test_cluster_ranks_cover_each_row_once(group):
    """Every row of a KV tile is summed by exactly one rank of the cluster,
    for every group the bf16 kernel takes (1-8)."""
    rows = [i for rr in rank_rows(group) for i in rr]
    assert sorted(rows) == list(range(TILE))
