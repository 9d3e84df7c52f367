"""The hand-written CUDA kernels of repro_torch against their plain
PyTorch versions, on the GPU. Every test is marked ``cuda`` and skips
without a GPU. The file imports neither ``jax`` nor ``repro``, so it runs
on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels.py: fp32 2e-5, bf16 5e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.attention import GLOBAL_WINDOW

DTYPES = ("float32", "bfloat16")
FLASH_CASES = [                               # tests/test_kernels.py sweep
    (2, 128, 4, 2, 64, True, None),
    (1, 256, 4, 1, 32, True, 64),
    (2, 100, 8, 8, 16, True, None),           # ragged S
    (1, 64, 4, 4, 128, False, None),          # non-causal
    (1, 64, 16, 2, 8, True, 16),              # deep GQA + window
    (1, 500, 16, 2, 128, True, None),         # qwen2.5-3b prefill
]
RMS_SHAPES = [(8, 64), (2, 17, 128), (100, 256), (4, 1, 2048)]


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
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 4, 96), device=cuda)          # hd 96 unsupported
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="window"):
        flash_attention(q[..., :64], q[:, :, :2, :64], q[:, :, :2, :64],
                        window=0)
    qd = torch.zeros((2, 4, 64), device=cuda)
    kc = torch.zeros((2, 16, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(qd, kc, kc, torch.ones(2, device=cuda))
    with pytest.raises(TypeError):
        rmsnorm(torch.zeros((2, 8), dtype=torch.float16, device=cuda),
                torch.zeros(8, device=cuda))
