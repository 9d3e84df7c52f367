"""The flash-attention backward kernels' tile plan, emulated on the CPU.

``csrc/flash_attention_bwd.cu`` runs three passes. The dq pass takes one
CTA per (query tile, q head, row), computes the tile's D = rowsum(dO o O)
and walks the KV tiles from ``key_range``; the dk/dv pass takes one CTA
per (KV tile, q head, row), walks the query tiles from ``query_range``
and writes that head's partial dK, dV; the last pass sums each KV head's
group of partials in head order. This file replays those loops in
float64 with
the kernels' tile sizes (bf16 plan: 64-query / 32-key steps in the dq
pass, 64-key / 32-query steps in the dk/dv pass; fp32 plan 16/32 and
16/32), the same range arithmetic and the same mask, and holds the result
to ``torch.autograd`` of ``kernels/ref.py:flash_attention_ref`` (whose
logits are fp32: within 1e-5 of each gradient's max |g|, or of 1 where
that is smaller: a window of one makes dq and dk exactly 0). It also
checks that each pass visits every visible (query, key) pair exactly
once, so a tile the ranges skip or visit twice shows here, before the
card.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import check_window
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models.attention import GLOBAL_WINDOW

PLANS = {"bf16": dict(bq1=64, bk1=32, bk2=64, bq2=32),
         "fp32": dict(bq1=16, bk1=32, bk2=16, bq2=32)}


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


def visible(S, causal, window, qpos, kpos):
    ok = (qpos[:, None] < S) & (kpos[None, :] < S)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def emulate(q, k, v, dout, causal, window, scale, plan):
    """(dq, dk, dv, visits of the dq pass, visits of the dk/dv pass)."""
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

    part_k = torch.zeros((B, S, Hq, hd), dtype=q.dtype)
    part_v = torch.zeros_like(part_k)
    for b in range(B):
        for h in range(Hq):
            hk = h // group
            for q0 in range(0, S, plan["bq1"]):
                rows = slice(q0, min(q0 + plan["bq1"], S))
                start, hi = key_range(S, causal, win, q0, rows.stop - 1,
                                      plan["bk1"])
                for k0 in range(start, hi, plan["bk1"]):
                    keys = slice(k0, min(k0 + plan["bk1"], S))
                    m, _, ds = tile(b, h, hk, rows, keys)
                    seen_q[b, h, rows, keys] += m.long()
                    dq[b, rows, h] += ds @ k[b, keys, hk]
            for k0 in range(0, S, plan["bk2"]):
                keys = slice(k0, min(k0 + plan["bk2"], S))
                start, hi = query_range(S, causal, win, k0, keys.stop - 1,
                                        plan["bq2"])
                for q0 in range(start, hi, plan["bq2"]):
                    rows = slice(q0, min(q0 + plan["bq2"], S))
                    m, p, ds = tile(b, h, hk, rows, keys)
                    seen_kv[b, h, rows, keys] += m.long()
                    part_v[b, keys, h] += p.T @ dout[b, rows, h]
                    part_k[b, keys, h] += ds.T @ qs[b, rows, h]
    for hk in range(Hkv):             # the group's partials, in head order
        for h in range(hk * group, hk * group + group):
            dk[:, :, hk] += part_k[:, :, h]
            dv[:, :, hk] += part_v[:, :, h]
    return dq * scale, dk, dv, seen_q, seen_kv, mask


CASES = [  # B, S, Hq, Hkv, hd, causal, window
    (1, 100, 8, 1, 16, True, None),        # GQA group 8, ragged last tile
    (2, 130, 4, 2, 32, True, 40),          # a window across tile edges
    (1, 97, 2, 2, 16, False, None),        # no mask but the ragged edge
    (1, 90, 4, 4, 16, False, 20),          # a window without causality
    (1, 70, 4, 2, 16, True, GLOBAL_WINDOW),    # the "no window" sentinel
    (1, 160, 2, 1, 16, True, 1),           # a window of one: the diagonal
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
    dq, dk, dv, seen_q, seen_kv, mask = emulate(q, k, v, dout, causal,
                                                window, scale, PLANS[plan])
    # every visible pair exactly once per head in each pass, nothing else
    want = mask.long().expand_as(seen_q)
    assert torch.equal(seen_q, want)
    assert torch.equal(seen_kv, want)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_ref(*ins, causal=causal, window=window, scale=scale)
    grads = torch.autograd.grad(out, ins, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        err = float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                   1.0)
        assert err < 1e-5, f"{name}: {err:.3e}"
