"""The rmsnorm backward kernel's one-pass plan, emulated on the CPU.

``csrc/rmsnorm_bwd.cu`` reads dy and x once for both gradients. Block k
of ``rmsnorm_bwd_rows_kernel`` owns rows [k * rpb, (k + 1) * rpb), where
rpb = ceil(rows / min(rows, 264)) depends on the shape alone; its 256
threads lie across the row (thread t holds the 16-byte pieces t, t + 256,
... of each row, at most four; other widths take the scalar variant, an
element a thread), it takes each row's sums of x^2 and g*x over the 8
warps in warp order, writes dx, and adds dy * x * r to its columns' sums
in row order; the block's sums are its fp32 partial row of dw. A second
kernel sums each column's partials over 32 warps (warp w takes blocks w,
w + 32, ... in order) and then the warps' sums in warp order.

This file replays that plan in float64 — the chunks, the rows a batch,
the thread of each column, the order of every sum — and holds it to
autograd of ``kernels/ref.py:rmsnorm_ref`` (``rmsnorm_bwd_ref``, which
computes in fp32: within 1e-5 of each gradient's largest |g|). It also
checks that every row lies in exactly one block and every column belongs
to exactly one thread, so a chunk or a piece the plan drops or takes twice
shows here, before the card.
"""
import pytest
import torch

from repro_torch.kernels.ref import rmsnorm_bwd_ref

THREADS, WARPS, TARGET_BLOCKS, MAX_PIECES = 256, 8, 264, 4
FINAL_WARPS = 32                                # rmsnorm_dw_final_kernel
PIECE = {torch.bfloat16: 8, torch.float32: 4}   # elements in 16 bytes


def rows_per_block(rows):
    """rmsnorm_bwd.cu:rows_per_block."""
    return -(-rows // min(rows, TARGET_BLOCKS))


def plan(rows, D, piece):
    """(rows a block, blocks, vector variant, pieces a thread, rows a
    batch), as rmsnorm_bwd.cu:launch picks them for aligned tensors."""
    rpb = rows_per_block(rows)
    pieces = -(-(D // piece) // THREADS)
    vec = D % piece == 0 and pieces <= MAX_PIECES
    rb = {1: 4, 2: 2}.get(pieces, 1) if vec else 1
    return rpb, -(-rows // rpb), vec, pieces, rb


def column_threads(D, piece, vec, pieces):
    """The thread that holds each column, from the kernels' loops (vector:
    pieces c = (p * 256 + t) * piece, p < pieces, c < D; scalar:
    c = t, t + 256, ...), and how many times each column is held."""
    owner = torch.full((D,), -1, dtype=torch.int64)
    held = torch.zeros(D, dtype=torch.int64)
    for t in range(THREADS):
        if vec:
            starts = [(p * THREADS + t) * piece for p in range(pieces)]
            cs = [c0 + j for c0 in starts if c0 < D for j in range(piece)]
        else:
            cs = list(range(t, D, THREADS))
        owner[cs] = t
        held[cs] += 1
    return owner, held


def block_sum(v, owner):
    """A row's sum as the block takes it: each thread's share, the warps'
    shuffle sums, then the 8 warps in order."""
    per_thread = torch.zeros(THREADS, dtype=v.dtype).index_add_(0, owner, v)
    total = torch.zeros((), dtype=v.dtype)
    for w in per_thread.view(WARPS, 32).sum(1):
        total = total + w
    return total


def emulate(dy, x, w, eps, piece):
    """(dx, dw, rows seen, columns seen) of the plan, in float64."""
    rows, D = x.shape
    rpb, blocks, vec, pieces, rb = plan(rows, D, piece)
    owner, held = column_threads(D, piece, vec, pieces)
    g1 = 1.0 + w
    dx = torch.empty_like(x)
    part = torch.zeros((blocks, D), dtype=x.dtype)
    seen = torch.zeros(rows, dtype=torch.int64)
    for k in range(blocks):
        r1 = min(rows, (k + 1) * rpb)
        for row0 in range(k * rpb, r1, rb):
            for row in range(row0, min(row0 + rb, r1)):
                seen[row] += 1
                xr, dyr = x[row], dy[row]
                ss = block_sum(xr * xr, owner)
                sgx = block_sum(dyr * g1 * xr, owner)
                r = torch.rsqrt(ss / D + eps)
                dx[row] = r * (dyr * g1 - xr * (r * r * (sgx / D)))
                part[k] += dyr * xr * r
    dw = torch.zeros(D, dtype=x.dtype)      # the final kernel's order
    for w8 in range(FINAL_WARPS):
        by_warp = torch.zeros(D, dtype=x.dtype)
        for k in range(w8, blocks, FINAL_WARPS):
            by_warp += part[k]
        dw += by_warp
    return dx, dw, seen, held


CASES = [  # rows, D, x dtype (its 16-byte piece)
    (1024, 2048, torch.bfloat16),   # the training rows: 256 blocks of 4
    (111, 2047, torch.bfloat16),    # an odd width: the scalar variant
    (1, 2048, torch.bfloat16),      # one row
    (6, 8192, torch.bfloat16),      # rows fewer than blocks, four pieces
    (565, 2048, torch.bfloat16),    # chunks of 3, the last one row
    (13, 2048, torch.float32),      # fp32 x: two pieces, batches of 2
    (3, 100, torch.float32),        # fewer pieces than threads
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}-"
                         f"{str(c[2]).split('.')[-1]}")
def test_one_pass_plan_matches_autograd_of_the_oracle(case):
    rows, D, xdt = case
    gen = torch.Generator().manual_seed(0)
    x, dy = (torch.randn((rows, D), generator=gen, dtype=torch.float64)
             for _ in range(2))
    w = torch.randn((D,), generator=gen, dtype=torch.float64) * 0.1
    dx, dw, seen, held = emulate(dy, x, w, 1e-5, PIECE[xdt])
    assert torch.equal(seen, torch.ones_like(seen))     # each row once
    assert torch.equal(held, torch.ones_like(held))     # each column once
    rdx, rdw = rmsnorm_bwd_ref(dy, x, w)
    for name, got, ref in (("dx", dx, rdx), ("dw", dw, rdw)):
        err = float((got - ref.double()).abs().max()) / float(
            ref.abs().max())
        assert err < 1e-5, f"{name}: {err:.3e}"


@pytest.mark.parametrize("rows", [1, 7, 263, 264, 265, 1024, 4096, 100003])
def test_row_chunks_depend_on_the_shape_alone(rows):
    """The chunks tile the rows exactly, there are at most 264 of them,
    the last is never empty, and neither the width nor the dtype moves
    them (so the order of every dw sum is the shape's)."""
    rpb, blocks, *_ = plan(rows, 2048, 8)
    assert blocks <= TARGET_BLOCKS
    assert (blocks - 1) * rpb < rows <= blocks * rpb
    for D, piece in [(2047, 8), (8192, 8), (100, 4)]:
        assert plan(rows, D, piece)[:2] == (rpb, blocks)
