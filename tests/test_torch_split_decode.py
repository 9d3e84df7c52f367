"""The split-KV decode attention plan and its merge, on the CPU.

The CUDA kernel (``kernels/csrc/decode_attention.cu``) cuts the cache into
``split_plan``'s chunks. A first pass writes each chunk's scores and
softmax statistics (m, l), a second the chunk's P V with the
probabilities normalised by the merged statistics and rounded to q's
dtype, a third sums the chunks. It runs only on the card, so this file
emulates the same passes in torch, on the same plan, and holds them
against the JAX oracle
``repro.kernels.ref.decode_attention_ref`` on numpy inputs from a seed:
lengths 0, 1, one chunk, S and past S, windows that empty whole splits,
and gemma3-1b's head dim 256 with group 4 and window 512.

Tolerances are those of tests/test_kernels.py: fp32 2e-5, bf16 5e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels.decode_attention import (MIN_CHUNK, SMEM_KV_BYTES,
                                                  split_plan)
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.convert import tensor_from_numpy

DTYPES = ("float32", "bfloat16")


def tol(dtype: str) -> dict:
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def pair(rng, shape, dtype: str):
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                    ).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def visible(length: int, S: int, window, chunk: int, split: int):
    """The part [a, e) of a split's chunk that a row of ``length`` sees,
    and whether the row sees no key at all (then it takes all of [0, S)
    with scores 0)."""
    lo = max(0, length - window) if window else 0
    hi = min(length, S)
    uniform = lo >= hi
    if uniform:
        lo, hi = 0, S
    return max(lo, split * chunk), min(hi, (split + 1) * chunk), uniform


def split_passes(q, k, v, lengths, window, scale, plan):
    """The kernel's three passes in torch. Scores: per (row, query head,
    split) the visible keys' scores, the chunk's max m and sum of exp l;
    (-1e30, 0) where nothing is visible. P V: the probabilities
    normalised by the row's max and sum merged from every split, rounded
    to q's dtype, times the chunk's V rows, in fp32. Combine: the splits
    summed, in q's dtype. Returns (m, l, acc, out)."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    m = torch.full((B, Hq, plan.splits), NEG_INF)
    l = torch.zeros((B, Hq, plan.splits))
    scores = {}
    for b in range(B):
        for sp in range(plan.splits):
            a, e, uniform = visible(int(lengths[b]), S, window, plan.chunk, sp)
            if e <= a:
                continue
            for hk in range(Hkv):
                heads = slice(hk * group, (hk + 1) * group)
                s = qs[b, heads] @ k[b, a:e, hk].float().T        # (group, n)
                if uniform:
                    s = torch.zeros_like(s)
                scores[b, hk, sp] = s
                m[b, heads, sp] = s.max(-1).values
                l[b, heads, sp] = torch.exp(s - m[b, heads, sp, None]).sum(-1)
    M = m.max(-1, keepdim=True).values
    L = (l * torch.exp(m - M)).sum(-1)                           # (B, Hq)
    acc = torch.zeros((B, Hq, plan.splits, hd))
    for (b, hk, sp), s in scores.items():
        a, e, _ = visible(int(lengths[b]), S, window, plan.chunk, sp)
        heads = slice(hk * group, (hk + 1) * group)
        p = torch.exp(s - M[b, heads]) / L[b, heads, None]
        p = p.to(q.dtype).float()                # the reference's rounding
        acc[b, heads, sp] = p @ v[b, a:e, hk].float()
    return m, l, acc, acc.sum(-2).to(q.dtype)


CASES = [                  # B, S, Hq, Hkv, hd, window, lengths ("C" = chunk)
    (5, 256, 4, 2, 32, None, [0, 1, "C", 256, 293]),
    (5, 256, 4, 2, 32, 24, [0, 1, "C", 256, 293]),
    (3, 512, 8, 2, 64, 40, [300, 512, 700]),     # most splits emptied
    (2, 640, 4, 1, 256, 512, [600, 740]),        # gemma3-1b local layer
    (2, 1024, 16, 2, 128, None, [144, 516]),     # qwen2.5-3b decode step
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window,lengths", CASES)
def test_split_kv_merge_matches_reference(B, S, Hq, Hkv, hd, window, lengths,
                                          dtype):
    rng = np.random.default_rng(11)
    qj, qt = pair(rng, (B, Hq, hd), dtype)
    kj, kt = pair(rng, (B, S, Hkv, hd), dtype)
    vj, vt = pair(rng, (B, S, Hkv, hd), dtype)
    plan = split_plan(S, hd, getattr(torch, dtype))
    lens = np.array([plan.chunk if n == "C" else n for n in lengths],
                    np.int32)
    m, l, acc, got = split_passes(qt, kt, vt, lens, window, hd ** -0.5,
                                  plan)
    shapes = plan.workspace_shapes(B, Hq, hd)
    assert (tuple(m.shape), tuple(l.shape), tuple(acc.shape)) == \
        (shapes["m"], shapes["l"], shapes["acc"])
    assert sum(np.prod(x) for x in shapes.values()) == \
        plan.workspace_floats(B, Hq, hd)
    want = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(lens),
                                     window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol(dtype))


def test_window_empties_whole_splits():
    """The emulation really takes the empty-split path: with window 40 a
    row of length 300 sees 2-3 of the 32 chunks of 16 rows."""
    plan = split_plan(512, 64, torch.float32)
    q, k = torch.zeros((1, 2, 64)), torch.zeros((1, 512, 1, 64))
    m, l, acc, _ = split_passes(q, k, k, [300], 40, 0.125, plan)
    empty = (l[0, 0] == 0)
    assert plan.chunk == MIN_CHUNK and int(empty.sum()) >= plan.splits - 3
    assert bool((m[0, 0][empty] == NEG_INF).all())
    assert bool((acc[0, 0][empty] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 100, 1024, 32768])
@pytest.mark.parametrize("hd", [8, 128, 256])
def test_split_plan_covers_the_cache(S, hd, dtype):
    plan = split_plan(S, hd, dtype)
    esize = torch.empty((), dtype=dtype).element_size()
    assert plan.chunk >= MIN_CHUNK and plan.chunk & (plan.chunk - 1) == 0
    assert (plan.splits - 1) * plan.chunk < S <= plan.splits * plan.chunk
    assert 2 * plan.chunk * hd * esize <= SMEM_KV_BYTES


def test_split_plan_at_the_serving_shapes():
    """qwen2.5-3b and zamba2-2.7b decode over a 1024-row cache: chunks of
    32 rows, 32 splits (256 CTAs at 4 rows x 2 KV heads)."""
    for hd in (128, 80, 256):
        plan = split_plan(1024, hd, torch.bfloat16)
        assert (plan.chunk, plan.splits) == (32, 32)
    with pytest.raises(ValueError):
        split_plan(0, 128, torch.bfloat16)
