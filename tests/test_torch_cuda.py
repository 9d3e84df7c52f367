"""The hand-written CUDA kernels of repro_torch against their plain
PyTorch versions, on the GPU. Every test is marked ``cuda`` and skips
without a GPU. The file imports neither ``jax`` nor ``repro``, so it runs
on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels.py: fp32 2e-5, bf16 5e-2, and
1e-3 for the SSD scan's fp32 final state.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.attention import GLOBAL_WINDOW

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
]
DECODE_SPLIT_CASES = [                        # B, S, Hq, Hkv, hd, window, lengths
    (2, 1024, 4, 1, 256, 512, [700, 1024]),   # gemma3-1b local layer
    (2, 1024, 4, 1, 256, None, [0, 1500]),    # gemma3-1b global layer
    (3, 1024, 16, 2, 128, None, [45, 77, 1000]),   # lengths end mid-split
    (2, 1024, 16, 2, 128, 20, [1000, 33]),    # most splits empty
    (2, 100, 8, 1, 32, 7, [100, 64]),         # ragged S, one split's edge
    (1, 64, 16, 2, 8, None, [3]),
]
RMS_SHAPES = [(8, 64), (2, 17, 128), (100, 256), (4, 1, 2048),
              (4, 1, 2560), (4, 1, 1536),     # zamba2, mamba2 decode rows
              (3, 100),                       # D not a multiple of 8
              (13, 2048)]                     # rows not a multiple of 8
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
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan(x, dt, A, bc, bc, chunk=1 << 16)
