"""The hand-written CUDA kernels of repro_torch against their plain
PyTorch versions, on the GPU. Every test is marked ``cuda`` and skips
without a GPU. The file imports neither ``jax`` nor ``repro``, so it runs
on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels.py: fp32 2e-5, bf16 5e-2, and
1e-3 for the SSD scan's fp32 final state.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.attention import GLOBAL_WINDOW
from repro_torch.models.programs import ModelProgram

DTYPES = ("float32", "bfloat16")
FLASH_CASES = [                               # tests/test_kernels.py sweep
    (2, 128, 4, 2, 64, True, None),
    (1, 256, 4, 1, 32, True, 64),
    (2, 100, 8, 8, 16, True, None),           # ragged S
    (1, 64, 4, 4, 128, False, None),          # non-causal
    (1, 64, 16, 2, 8, True, 16),              # deep GQA + window
    (1, 500, 16, 2, 128, True, None),         # qwen2.5-3b prefill
    (1, 500, 32, 32, 80, True, None),         # zamba2-2.7b shared block
    (1, 640, 4, 1, 256, True, 512),           # gemma3-1b local layer
    (2, 200, 4, 1, 256, True, None),          # gemma3-1b global layer
    (2, 333, 8, 2, 128, True, None),          # S not a multiple of 64
    (1, 150, 4, 2, 80, False, 40),            # ragged, window, non-causal
    (1, 500, 16, 8, 64, True, None),          # granite-moe-1b-a400m
    (4, 128, 32, 32, 64, True, None),         # musicgen-large
    (1, 300, 48, 8, 128, True, None),         # dbrx-132b: group 6
    (2, 300, 64, 8, 128, True, None),         # internvl2-76b: group 8
]
DECODE_SPLIT_CASES = [                        # B, S, Hq, Hkv, hd, window, lengths
    (2, 1024, 4, 1, 256, 512, [700, 1024]),   # gemma3-1b local layer
    (2, 1024, 4, 1, 256, None, [0, 1500]),    # gemma3-1b global layer
    (3, 1024, 16, 2, 128, None, [45, 77, 1000]),   # lengths end mid-split
    (2, 1024, 16, 2, 128, 20, [1000, 33]),    # most splits empty
    (2, 100, 8, 1, 32, 7, [100, 64]),         # ragged S, one split's edge
    (1, 64, 16, 2, 8, None, [3]),
    (4, 1024, 16, 8, 64, None, [0, 1, 700, 1500]),   # granite-moe-1b-a400m
    (4, 1024, 48, 8, 128, None, [532, 45, 1000, 77]),  # dbrx-132b: G=8 of 6
    (4, 1024, 64, 8, 128, None, [532, 1, 1024, 700]),  # internvl2-76b
]
RMS_SHAPES = [(8, 64), (2, 17, 128), (100, 256), (4, 1, 2048),
              (4, 1, 2560), (4, 1, 1536),     # zamba2, mamba2 decode rows
              (3, 100),                       # D not a multiple of 8
              (13, 2048),                     # rows not a multiple of 8
              (4, 1, 1024), (4, 1, 1152),     # granite-moe, gemma3
              (4, 1, 6144), (4, 500, 8192)]   # dbrx, internvl: scalar variant
SSD_CASES = [                                 # B, S, H, P, N, chunk, init
    (1, 500, 80, 64, 64, 256, False),         # zamba2-2.7b prefill
    (1, 500, 48, 64, 128, 256, False),        # mamba2-780m prefill
    (2, 64, 4, 16, 16, 16, False),            # tests/test_kernels.py sweep
    (1, 100, 2, 32, 64, 32, True),            # ragged + init state
    (2, 33, 4, 64, 32, 8, False),
    (1, 5, 8, 16, 16, 5, False),              # S < 8, chunk = S
    (2, 300, 16, 64, 128, 256, True),         # B = 2, two chunks, init
    (1, 128, 80, 64, 64, 128, False),         # zamba2's 128-token prompt
    (1, 257, 4, 64, 64, 256, False),          # one row into a second chunk
    (1, 1024, 4, 64, 64, 256, False),         # four chunks
    (2, 200, 4, 64, 128, 256, True),          # B = 2, init, N 128
    (1, 300, 4, 8, 64, 256, False),           # P 8, padded to 16
    (1, 300, 4, 128, 128, 256, True),         # P 128
]


def tol(dtype: str) -> dict:
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def f32(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


@pytest.fixture
def cuda():
    """Decided at run time, never at import: xdist workers must collect
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, B, S, Hq, Hkv, hd, causal, window,
                                    dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dt)
               for shape in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    n = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == n + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    if window is None:
        assert torch.equal(got, flash_attention(q, k, v, causal=causal,
                                                window=GLOBAL_WINDOW))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths,window", [([0, 1, 700, 1500], None),
                                            ([0, 1, 700, 1500], 256),
                                            ([1100, 1300, 5, 1024], 256)])
def test_decode_kernel_matches_plain(cuda, lengths, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn((4, 16, 128), generator=g, device=cuda).to(dt)
    kc, vc = (torch.randn((4, 1024, 2, 128), generator=g, device=cuda).to(dt)
              for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n = decode_attention.launches
    got = decode_attention(q, kc, vc, lens, window=window)
    assert decode_attention.launches == n + 1
    want = ref.decode_attention_ref(q, kc, vc, lens, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths", [[0, 1, 700, 1500], [1100, 1300, 5, 1024]])
def test_decode_kernel_hd80_matches_plain(cuda, lengths, dtype):
    """zamba2-2.7b's shared block: 32 q and 32 KV heads of dim 80."""
    g = torch.Generator(device=cuda).manual_seed(1)
    dt = getattr(torch, dtype)
    q = torch.randn((4, 32, 80), generator=g, device=cuda).to(dt)
    kc, vc = (torch.randn((4, 1024, 32, 80), generator=g, device=cuda).to(dt)
              for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = decode_attention(q, kc, vc, lens)
    want = ref.decode_attention_ref(q, kc, vc, lens)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window,lengths", DECODE_SPLIT_CASES)
def test_decode_kernel_split_edges_match_plain(cuda, B, S, Hq, Hkv, hd, window,
                                               lengths, dtype):
    """Split-KV edges: head dim 256 (gemma3-1b: group 4, window 512),
    lengths that end inside a split, windows that leave most splits
    empty, length 0 and length > S."""
    g = torch.Generator(device=cuda).manual_seed(3)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Hq, hd), generator=g, device=cuda).to(dt)
    kc, vc = (torch.randn((B, S, Hkv, hd), generator=g, device=cuda).to(dt)
              for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n = decode_attention.launches
    got = decode_attention(q, kc, vc, lens, window=window)
    assert decode_attention.launches == n + 1
    want = ref.decode_attention_ref(q, kc, vc, lens, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


def ssd_inputs(g, B, S, H, P, N, init, dtype, device):
    """tests/test_kernels.py's distribution; x, B, C in ``dtype``."""
    rn = lambda *shape: torch.randn(shape, generator=g, device=device)
    x = rn(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H))
    A = -torch.exp(rn(H) * 0.3)
    Bm = (rn(B, S, N) * 0.5).to(dtype)
    Cm = (rn(B, S, N) * 0.5).to(dtype)
    s0 = rn(B, H, P, N) if init else None
    return x, dt, A, Bm, Cm, s0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,N,chunk,init", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(cuda, B, S, H, P, N, chunk, init,
                                       dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x, dt, A, Bm, Cm, s0 = ssd_inputs(g, B, S, H, P, N, init,
                                      getattr(torch, dtype), cuda)
    n = ssd_scan.launches
    y, sf = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0,
                     return_state=True)
    assert ssd_scan.launches == n + 1
    yr, sr = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0,
                              return_state=True)
    assert y.dtype == x.dtype and sf.dtype == torch.float32
    np.testing.assert_allclose(f32(y), f32(yr), **tol(dtype))
    np.testing.assert_allclose(f32(sf), f32(sr), atol=1e-3, rtol=1e-3)
    assert torch.equal(ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                init_state=s0), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_kernel_reads_column_slices(cuda, dtype):
    """The serving path's layout: x, Bm and Cm are column slices of one
    (B, S, H*P + 2N) projection, unit stride only in the last dim."""
    g = torch.Generator(device=cuda).manual_seed(2)
    B, S, H, P, N = 2, 200, 8, 64, 64
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g,
                      device=cuda).to(getattr(torch, dtype))
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g,
                                                  device=cuda))
    A = -torch.exp(torch.randn((H,), generator=g, device=cuda) * 0.3)
    assert not x.is_contiguous() and not Cm.is_contiguous()
    y, sf = ssd_scan(x, dt, A, Bm, Cm, chunk=128, return_state=True)
    yc, sc = ssd_scan(x.contiguous(), dt, A, Bm.contiguous(),
                      Cm.contiguous(), chunk=128, return_state=True)
    assert torch.equal(y, yc) and torch.equal(sf, sc)
    yr = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=128)
    np.testing.assert_allclose(f32(y), f32(yr), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(getattr(torch, dtype))
    w = torch.randn(shape[-1:], generator=g, device=cuda) * 0.1
    n = rmsnorm.launches
    got = rmsnorm(x, w)
    assert rmsnorm.launches == n + 1
    np.testing.assert_allclose(f32(got), f32(ref.rmsnorm_ref(x, w)),
                               **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_takes_unaligned_rows(cuda, dtype):
    """A view whose data pointer is one element off a 16-byte boundary
    takes the kernel's scalar variant."""
    g = torch.Generator(device=cuda).manual_seed(4)
    base = torch.randn(4 * 2048 + 1, generator=g, device=cuda)
    x = base.to(getattr(torch, dtype))[1:].view(4, 1, 2048)
    w = torch.randn(2048, generator=g, device=cuda) * 0.1
    assert x.data_ptr() % 16 and x.is_contiguous()
    np.testing.assert_allclose(f32(rmsnorm(x, w)), f32(ref.rmsnorm_ref(x, w)),
                               **tol(dtype))


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 4, 96), device=cuda)          # hd 96 unsupported
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="window"):
        flash_attention(q[..., :64], q[:, :, :2, :64], q[:, :, :2, :64],
                        window=0)
    qb = torch.zeros((1, 8, 4, 65), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):     # strides of 65
        flash_attention(qb[..., :64], qb[:, :, :2, :64], qb[:, :, :2, :64])
    qd = torch.zeros((2, 4, 64), device=cuda)
    kc = torch.zeros((2, 16, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(qd, kc, kc, torch.ones(2, device=cuda))
    with pytest.raises(TypeError):
        rmsnorm(torch.zeros((2, 8), dtype=torch.float16, device=cuda),
                torch.zeros(8, device=cuda))
    x = torch.zeros((1, 8, 2, 16), device=cuda)
    dt, A = torch.zeros((1, 8, 2), device=cuda), torch.zeros(2, device=cuda)
    bc = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan(torch.zeros((1, 8, 2, 24), device=cuda), dt, A, bc, bc)
    with pytest.raises(TypeError, match="fp32"):
        ssd_scan(x, dt.bfloat16(), A, bc, bc)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(torch.zeros((1, 8, 16, 2), device=cuda).transpose(-1, -2),
                 dt, A, bc, bc)
    # a chunk is cut to S (the same scan under dt = 0 padding), so only a
    # chunk that really is that long needs too much shared memory
    S = 1 << 15
    xl, dtl = torch.zeros((1, S, 2, 16), device=cuda), \
        torch.zeros((1, S, 2), device=cuda)
    bcl = torch.zeros((1, S, 16), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan(xl, dtl, A, bcl, bcl, chunk=S)
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    b129 = torch.zeros((1, 8, 129), device=cuda)
    with pytest.raises(ValueError, match="N=129"):
        ssd_scan_bwd(x, x, dt, A, b129, b129, chunk=8, saved=())
    with pytest.raises(ValueError, match="saved"):
        ssd_scan_bwd(x, x, dt, A, bc, bc, chunk=8)
    # bf16 flash backward: a KV head's group is one thread block cluster
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    q16 = torch.zeros((1, 64, 16, 64), dtype=torch.bfloat16, device=cuda)
    k1 = torch.zeros((1, 64, 1, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="GQA group of 16"):
        FlashAttentionFn.apply(q16, k1, k1, True, None, None)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m",
                                  "internvl2-76b", "musicgen-large"])
def test_prefill_of_several_rows_matches_plain(cuda, arch):
    """A prefill of 3 rows (an fp32 reduced config: the vlm with its
    prefix, the audio model on frames) and a decode step, kernel path
    against plain path. The last position of several rows is a strided
    view, which the final norm's kernel must be handed contiguous."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    prog = ModelProgram(cfg)
    params = prog.init(0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    emb = lambda *shape: torch.randn(shape, generator=gen, device=cuda)
    toks = lambda *shape: torch.randint(0, cfg.vocab_size, shape,
                                        generator=gen, device=cuda,
                                        dtype=torch.int32)
    B, S = 3, 20
    if cfg.family == "audio":
        pre, dec = {"embeds": emb(B, S, cfg.d_model)}, \
            {"embeds": emb(B, 1, cfg.d_model)}
    else:
        pre, dec = {"tokens": toks(B, S - cfg.frontend_tokens)}, \
            {"tokens": toks(B, 1)}
        if cfg.frontend_tokens:
            pre["embeds"] = emb(B, cfg.frontend_tokens, cfg.d_model)

    def run():
        logits, cache = prog.prefill(params, pre)
        cache = {k: torch.cat([v, torch.zeros_like(v[:, :, :4])], 2)
                 if k in ("k", "v") else v for k, v in cache.items()}
        return logits, prog.decode_step(params, cache, dec)[0]

    with torch.no_grad():
        got = run()
        ops.set_kernel_mode("ref")
        try:
            want = run()
        finally:
            ops.set_kernel_mode(None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(f32(g), f32(w), **tol("float32"))


# ---------------------------------------------------------------------------
# training: the backward kernels, the refusals, a train step
# ---------------------------------------------------------------------------
FLASH_BWD_CASES = [                           # B, S, Hq, Hkv, hd, causal, window
    (8, 128, 16, 2, 128, True, None),         # qwen2.5-3b training shape
    (1, 500, 16, 2, 128, True, None),         # a 500-token prompt
    (2, 128, 16, 8, 64, True, None),          # granite-moe-1b-a400m: group 2
    (1, 1024, 4, 1, 256, True, 512),          # gemma3-1b local layer
    (2, 333, 8, 2, 128, True, None),          # ragged S
    (1, 150, 4, 2, 80, False, 40),            # hd 80, non-causal window
    (2, 100, 8, 1, 16, True, None),           # hd 16 (reduced configs), G 8
    (1, 77, 4, 4, 32, True, 8),               # hd 32, a short window
    (2, 128, 12, 2, 128, True, None),         # a cluster of 6 (dbrx, nemotron)
    (1, 1024, 4, 1, 256, False, None),        # hd 256, non-causal
]
RMS_BWD_SHAPES = [(8, 128, 2048), (4, 1, 1024), (4, 1, 1152), (4, 1, 6144),
                  (2, 3, 8192), (3, 100), (13, 2048), (2, 17, 64),
                  (3, 37, 2048),              # 111 rows: a row a block
                  (5, 113, 2048)]             # 565 rows: chunks of 3, the last 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_autograd_of_plain(
        cuda, B, S, Hq, Hkv, hd, causal, window, dtype):
    """dq, dk, dv through ``FlashAttentionFn`` against autograd of the
    plain version, twice bit-equal (no atomics)."""
    from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                     flash_attention_bwd)
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dt)
               for shape in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    dout = torch.randn((B, S, Hq, hd), generator=g, device=cuda).to(dt)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    n = flash_attention_bwd.launches
    out = FlashAttentionFn.apply(*ins, causal, window, None)
    got = torch.autograd.grad(out, ins, dout)
    assert flash_attention_bwd.launches == n + 1
    again = torch.autograd.grad(FlashAttentionFn.apply(*ins, causal, window,
                                                       None), ins, dout)
    want = ref.flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                       window=window)
    for a, b, w in zip(got, again, want):
        assert a.dtype == dt and a.shape == w.shape
        assert torch.equal(a, b)
        np.testing.assert_allclose(f32(a), f32(w), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RMS_BWD_SHAPES)
def test_rmsnorm_backward_kernel_matches_autograd_of_plain(cuda, shape, dtype,
                                                           wdtype):
    from repro_torch.kernels.rmsnorm import RMSNormFn, rmsnorm_bwd
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(getattr(torch, dtype))
    w = (torch.randn(shape[-1:], generator=g, device=cuda) * 0.1).to(
        getattr(torch, wdtype))
    dy = torch.randn(shape, generator=g, device=cuda).to(x.dtype)
    xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
    n = rmsnorm_bwd.launches
    got = torch.autograd.grad(RMSNormFn.apply(xi, wi, 1e-5), (xi, wi), dy)
    assert rmsnorm_bwd.launches == n + 1
    again = rmsnorm_bwd(dy, x, w)
    want = ref.rmsnorm_bwd_ref(dy, x, w)
    for a, b, ww in zip(got, again, want):
        assert a.dtype == ww.dtype
        assert torch.equal(a, b)
    np.testing.assert_allclose(f32(got[0]), f32(want[0]), **tol(dtype))
    # dw sums over every row: within the tolerance of its dtype relative
    # to the largest |dw|
    scale = float(want[1].float().abs().max())
    np.testing.assert_allclose(f32(got[1]) / scale, f32(want[1]) / scale,
                               **tol(wdtype))


def ssd_grads_close(got, want, x, dt, A, dtype, state_tol=1e-3):
    """(dx, ddt, dA, dB, dC[, d init_state]) within the dtype's tolerance
    of their largest |g|; dA of max_h sum_{b,s} |dt d a|, the sum of its
    terms' absolute values (d a = (ddt - sum_p x dx / dt) / A from the
    reference's gradients): its terms cancel, so an fp32 dA, the plain
    version's included, is off by a share of that sum
    (tests/test_torch_ssd_bwd.py); d init_state at the SSD state's 1e-3."""
    atol = tol(dtype)["atol"]
    dx, ddt = want[0].double(), want[1].double()
    terms = (dt.double() * ddt - (x.double() * dx).sum(-1)).abs().sum((0, 1))
    da_scale = float((terms / A.double().abs()).max())
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = da_scale if i == 2 else float(w.float().abs().max()) or 1.0
        t = state_tol if i == 5 else atol
        np.testing.assert_allclose(f32(g) / scale, f32(w) / scale, atol=t,
                                   rtol=0)


@pytest.mark.cuda
def test_kernels_without_a_backward_raise_under_autograd(cuda):
    """decode_attention (serving only) raises under autograd; ssd_scan,
    which has its backward kernel now, gives autograd of the plain
    version's gradients through it."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 4, 16), generator=g, device=cuda, requires_grad=True)
    kc = torch.randn((2, 32, 2, 16), generator=g, device=cuda)
    lengths = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        ops.decode_attention(q, kc, kc, lengths)
    x, dt, A, Bm, Cm, _ = ssd_inputs(g, 1, 16, 2, 16, 16, False,
                                     torch.float32, cuda)
    dy = torch.randn(x.shape, generator=g, device=cuda)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    n, nb = ssd_scan.launches, ssd_scan_bwd.launches
    y = ops.ssd_scan(*ins, chunk=8)
    got = torch.autograd.grad(y, ins, dy)
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == (n + 1, nb + 1)
    want = ref.ssd_scan_bwd_ref(dy, x, dt, A, Bm, Cm, chunk=8)
    ssd_grads_close(got, want[:5], x, dt, A, "float32")
    with torch.no_grad():      # the serving path keeps the kernels
        ops.decode_attention(q, kc, kc, lengths)
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,N,chunk,init", SSD_CASES + [
    (8, 128, 80, 64, 64, 128, False),         # zamba2-2.7b training
    (8, 128, 48, 64, 128, 128, False),        # mamba2-780m training
    (1, 6000, 2, 128, 128, 6000, True)])      # past the fused pass's smem
def test_ssd_scan_backward_kernel_matches_autograd_of_plain(
        cuda, B, S, H, P, N, chunk, init, dtype):
    """SsdScanFn (the forward keeps a_cs and the chunk states, the
    backward kernel reads them) against autograd of the plain version,
    with a final-state cotangent where there is an init state; a second
    backward call is bit-equal."""
    from repro_torch.kernels.ssd_scan import SsdScanFn, _forward, ssd_scan_bwd
    g = torch.Generator(device=cuda).manual_seed(5)
    x, dt, A, Bm, Cm, s0 = ssd_inputs(g, B, S, H, P, N, init,
                                      getattr(torch, dtype), cuda)
    dy = torch.randn(x.shape, generator=g, device=cuda).to(x.dtype)
    dfin = torch.randn((B, H, P, N), generator=g, device=cuda) \
        if init else None
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    s0i = s0.clone().requires_grad_() if init else None
    n = ssd_scan_bwd.launches
    y, sf = SsdScanFn.apply(*ins, s0i, chunk, True)
    outs, cots = ([y, sf], [dy, dfin]) if init else ([y], [dy])
    got = torch.autograd.grad(outs, ins + ([s0i] if init else []), cots)
    assert ssd_scan_bwd.launches == n + 1
    want = ref.ssd_scan_bwd_ref(dy, x, dt, A, Bm, Cm, chunk=chunk,
                                init_state=s0, dfinal=dfin)
    ssd_grads_close(list(got) + ([] if init else [None]), want, x, dt, A,
                    dtype)
    saved = _forward(x, dt, A, Bm, Cm, chunk, s0, False, save=True)[2]
    again = ssd_scan_bwd(dy, x, dt, A, Bm, Cm, chunk=chunk, init_state=s0,
                         dfinal=dfin, saved=saved)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_backward_reads_column_slices(cuda, dtype):
    """The training path's layout: x, Bm and Cm column slices of one
    projection; their gradients reach the projection through the
    slices' backward."""
    g = torch.Generator(device=cuda).manual_seed(6)
    B, S, H, P, N = 2, 200, 8, 64, 64
    dt_ = getattr(torch, dtype)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g, device=cuda)
    xbc[..., H * P:] *= 0.5
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g,
                                                  device=cuda))
    A = -torch.exp(torch.randn((H,), generator=g, device=cuda) * 0.3)
    dy = torch.randn((B, S, H, P), generator=g, device=cuda).to(dt_)
    grads = {}
    for mode in (None, "ref"):
        ops.set_kernel_mode(mode)
        try:
            leaf = xbc.to(dt_).requires_grad_()
            x = leaf[..., :H * P].reshape(B, S, H, P)
            y = ops.ssd_scan(x, dt, A, leaf[..., H * P:H * P + N],
                             leaf[..., H * P + N:], chunk=128)
            grads[mode] = torch.autograd.grad(y, leaf, dy)[0]
        finally:
            ops.set_kernel_mode(None)
    w = grads["ref"]
    scale = float(w.float().abs().max())
    np.testing.assert_allclose(f32(grads[None]) / scale, f32(w) / scale,
                               atol=tol(dtype)["atol"], rtol=0)


@pytest.mark.cuda
def test_ssm_train_step_is_refused_on_the_card(cuda):
    """Once refused, now trained: a train step on reduced mamba2-780m and
    reduced zamba2-2.7b runs the ssd_scan backward kernel once per Mamba2
    layer, every loss is finite and every parameter moves."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    from repro_torch.optim import AdamW, constant
    for arch in ("mamba2-780m", "zamba2-2.7b"):
        cfg = get_config(arch).reduced()
        prog = ModelProgram(cfg)
        params = prog.init(0, device=cuda)
        leaves = _leaves(params)
        before = [p.clone() for p in leaves]
        opt = AdamW(lr=constant(1e-3))
        step = prog.make_train_step(opt)
        g = torch.Generator(device=cuda).manual_seed(0)
        toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=g,
                             device=cuda, dtype=torch.int32)
        n = ssd_scan_bwd.launches
        _, _, mets = step(params, opt.init(params), {"tokens": toks,
                                                     "labels": toks})
        assert ssd_scan_bwd.launches - n == cfg.n_layers
        assert np.isfinite(float(mets["loss"]))
        for p, b in zip(leaves, before):
            assert not torch.equal(p, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma3-1b",
                                  "granite-moe-1b-a400m"])
def test_train_step_on_the_card_matches_plain(cuda, arch):
    """One reduced fp32 train step (n_micro 2) through the kernels and
    their backward kernels against the same step on the plain path."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    from repro_torch.optim import AdamW, warmup_cosine
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    prog = ModelProgram(cfg, remat=False)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=g,
                              device=cuda, dtype=torch.int32)
             for k in ("tokens", "labels")}
    out = {}
    for mode in (None, "ref"):
        ops.set_kernel_mode(mode)
        try:
            params = prog.init(0, device=cuda)
            opt = AdamW(lr=warmup_cosine(1e-2, 2, 10), eps=1e-3)
            nf, nr = flash_attention_bwd.launches, rmsnorm_bwd.launches
            _, state, mets = prog.make_train_step(opt, n_micro=2)(
                params, opt.init(params), batch)
            launched = (flash_attention_bwd.launches - nf,
                        rmsnorm_bwd.launches - nr)
        finally:
            ops.set_kernel_mode(None)
        out[mode] = (params, state, mets, launched)
    L = cfg.n_layers
    assert out[None][3] == (2 * L, 2 * (2 * L + 1))
    assert out["ref"][3] == (0, 0)
    np.testing.assert_allclose(float(out[None][2]["loss"]),
                               float(out["ref"][2]["loss"]), rtol=1e-5)
    for key in ("m", "v"):
        got, want = out[None][1][key], out["ref"][1][key]
        for a, b in zip(_leaves(got), _leaves(want)):
            scale = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) / scale < 1e-4
    for a, b in zip(_leaves(out[None][0]), _leaves(out["ref"][0])):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-4, atol=1e-5)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the batcher's decode graph (core/scheduler): replays against eager steps
# ---------------------------------------------------------------------------
GRAPH_ARCHS = [("mamba2-780m", None), ("zamba2-2.7b", 12),
               ("qwen2.5-3b", 4), ("gemma3-1b", 6),
               ("granite-moe-1b-a400m", 4)]      # (arch, layers kept)


def _graph_runtime(cuda, arch, layers, workers=False):
    """A runtime on the card serving ``arch`` at full width (``layers``
    of its depth, all when None), 4 slots of 1,024 positions, under the
    fids ``eager`` and ``graph`` (one spec, so one set of weights)."""
    from repro_torch.core import HydraRuntime, LMSpec
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    rt = HydraRuntime(device=cuda, memory_budget_bytes=1 << 40,
                      n_workers=4 if workers else 0, janitor=workers)
    spec = LMSpec(cfg=cfg, params=ModelProgram(cfg).init(
        0, device=cuda, dtype=torch.bfloat16), max_seq=1024, slots=4)
    for fid in ("eager", "graph", "alone"):
        rt.register_function(fid, spec)
    return rt, cfg


def _graph_schedule(vocab: int, n: int = 16) -> list:
    """(step, prompt, max_new): prompts of 40-700 tokens (past gemma3's
    512-token window), 3-12 new tokens, one request every 3 steps."""
    rng = np.random.default_rng(3)
    return [(3 * i, rng.integers(0, vocab, int(rng.integers(40, 700)))
             .tolist(), int(rng.integers(3, 13))) for i in range(n)]


def _serve(b, sched) -> list:
    sched, futs, step = list(sched), [], 0
    while sched or b.active or b.pending:
        while sched and sched[0][0] <= step:
            _, prompt, n = sched.pop(0)
            futs.append(b.submit(prompt, n))
        b.step()
        step += 1
    return [f.result() for f in futs]


def _batcher(rt, fid, graphs: bool, monkeypatch):
    from repro_torch.core import ContinuousBatcher, scheduler
    with monkeypatch.context() as m:
        if not graphs:
            m.setattr(scheduler, "_graphs_on", lambda device: False)
        return ContinuousBatcher(rt, fid)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", GRAPH_ARCHS)
def test_decode_graph_replays_equal_eager_steps(cuda, arch, layers,
                                                 monkeypatch):
    """Over 50 and more steps with admissions between, the graph
    batcher's tokens and its whole slab (free slots' rows included) are
    bit for bit the eager batcher's: one capture, every later step a
    replay. Each of two requests served alone, in slot 0, gives the
    tokens it got beside the others (slot rows stay apart)."""
    rt, cfg = _graph_runtime(cuda, arch, layers)
    try:
        sched = _graph_schedule(cfg.vocab_size)
        eager = _batcher(rt, "eager", False, monkeypatch)
        want = _serve(eager, sched)
        graph = _batcher(rt, "graph", True, monkeypatch)
        got = _serve(graph, sched)
        assert graph.steps == eager.steps >= 50
        assert got == want
        for k in eager.cache:
            assert torch.equal(graph.cache[k], eager.cache[k]), k
        c = rt.metrics.counters
        assert c["decode_graph.captures"] == 1
        assert c["decode_graph.replays"] == graph.steps - 1
        for b in (eager, graph):
            b.close()
        for i in (1, 6):
            alone = _batcher(rt, "alone", True, monkeypatch)
            assert _serve(alone, [(0,) + sched[i][1:]]) == [want[i]]
            alone.close()
    finally:
        rt.shutdown()


def _count_decodes(b, seen: list) -> None:
    """Record, per decode step of ``b``, (how, the kernel launches it
    added by wrapper)."""
    from repro_torch.kernels import ops
    decode = b._decode

    def counted():
        before = ops.launch_counts()
        tok, how = decode()
        after = ops.launch_counts()
        seen.append((how, {k: n - before[k] for k, n in after.items()
                           if n != before[k]}))
        return tok, how

    b._decode = counted


@pytest.mark.cuda
def test_decode_graphs_share_one_pool_and_count_their_launches(cuda,
                                                               monkeypatch):
    """Two runtimes' graph batchers on one card capture into one memory
    pool and are stepped in turn: each gives its eager batcher's tokens.
    Every decode step, eager, captured or replayed, adds the kernel
    launches an eager step adds."""
    from repro_torch.core import scheduler
    made = [_graph_runtime(cuda, arch, layers)
            for arch, layers in (("zamba2-2.7b", 6), ("qwen2.5-3b", 4))]
    try:
        scheds, want, eager_counts = [], [], []
        for rt, cfg in made:
            sched = _graph_schedule(cfg.vocab_size, n=6)
            eager = _batcher(rt, "eager", False, monkeypatch)
            seen = []
            _count_decodes(eager, seen)
            want.append(_serve(eager, sched))
            eager.close()
            assert {h for h, _ in seen} == {"eager"}
            assert all(c == seen[0][1] for _, c in seen) and seen[0][1]
            scheds.append(sched)
            eager_counts.append(seen[0][1])
        graphs = [_batcher(rt, "graph", True, monkeypatch)
                  for rt, _ in made]
        seen = [[], []]
        for b, s in zip(graphs, seen):
            _count_decodes(b, s)
        futs = [[], []]
        step = 0
        while any(scheds) or any(b.active or b.pending for b in graphs):
            for i, b in enumerate(graphs):     # in turn, one step each
                while scheds[i] and scheds[i][0][0] <= step:
                    _, prompt, n = scheds[i].pop(0)
                    futs[i].append(b.submit(prompt, n))
                if b.active or b.pending:
                    b.step()
            step += 1
        for i, b in enumerate(graphs):
            assert [f.result() for f in futs[i]] == want[i]
            hows = [h for h, _ in seen[i]]
            assert hows[:2] == ["eager", "capture"]
            assert set(hows[2:]) == {"replay"} and len(hows) > 10
            assert all(c == eager_counts[i] for _, c in seen[i])
            assert made[i][0].metrics.counters["decode_graph.captures"] == 1
        (_, anchor), = scheduler._capture_sides.values()
        assert [b._graph[1].pool() for b in graphs] == [anchor.pool()] * 2
        for b in graphs:
            b.close()
    finally:
        for rt, _ in made:
            rt.shutdown()


@pytest.mark.cuda
def test_decode_graph_captures_while_workers_use_the_card(cuda, monkeypatch):
    """The capture is thread_local: the runtime's workers keep invoking a
    function on the card (a matmul and a stream sync each) while the
    batcher captures, and both give what they give alone."""
    import threading
    from repro_torch.core import CallableSpec
    rt, cfg = _graph_runtime(cuda, "qwen2.5-3b", 4, workers=True)
    try:
        w = torch.randn(512, 512, device=cuda)
        rt.register_function("mm", CallableSpec(
            name="mm", fn=lambda p, a: a["x"] @ p["w"],
            example_args={"x": torch.ones(64, 512, device=cuda)},
            params={"w": w}))
        x = torch.randn(64, 512, device=cuda)
        want_y = x @ w
        sched = _graph_schedule(cfg.vocab_size, n=4)
        eager = _batcher(rt, "eager", False, monkeypatch)
        want = _serve(eager, sched)
        eager.close()
        stop, bad, calls = threading.Event(), [], [0]

        def invoke():
            while not stop.is_set():
                y = rt.invoke("mm", {"x": x})
                calls[0] += 1
                if not torch.equal(y, want_y):
                    bad.append(calls[0])

        threads = [threading.Thread(target=invoke) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            graph = _batcher(rt, "graph", True, monkeypatch)
            got = _serve(graph, sched)
        finally:
            stop.set()
            for t in threads:
                t.join()
        graph.close()
        assert got == want and not bad and calls[0] > 0
        assert rt.metrics.counters["decode_graph.captures"] == 1
    finally:
        rt.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rotary_fill_is_bitwise_the_host_copy_and_captures(cuda, theta):
    """rotary's theta, a fill on the device, gives the bits the host copy
    gave, and rotary now captures into a CUDA graph."""
    from repro_torch.models.layers import rotary
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(4, 1, 16, 128, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    pos = torch.randint(0, 4096, (4, 1), generator=g, device=cuda)
    f32, half = torch.float32, 64
    freq = torch.exp(-torch.log(torch.tensor(theta, dtype=f32, device=cuda))
                     * torch.arange(0, half, dtype=f32, device=cuda) / half)
    ang = (pos.to(f32)[..., None] * freq)[..., None, :]
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    want = torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                      x2 * ang.cos() + x1 * ang.sin()], dim=-1).to(x.dtype)
    assert torch.equal(rotary(x, pos, theta), want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rotary(x, pos, theta)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
