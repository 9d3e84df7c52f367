"""repro_torch kernels: the plain PyTorch oracles against the reference's
JAX oracles (and, once per kernel, the Pallas kernel in interpret mode),
and the dispatch rules of ``repro_torch.kernels.ops``. The CUDA kernels
against their plain versions are in tests/test_torch_cuda.py.

Inputs are drawn with numpy from a seed and handed to both frameworks.
Tolerances are those of tests/test_kernels.py: fp32 2e-5 (the two
frameworks sum in different orders), bf16 5e-2 (one bf16 ulp of the
outputs and of the rounded softmax probabilities).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.attention import GLOBAL_WINDOW
from repro_torch.models.convert import tensor_from_numpy

DTYPES = ("float32", "bfloat16")

FLASH_CASES = [                               # tests/test_kernels.py sweep
    (2, 128, 4, 2, 64, True, None),
    (1, 256, 4, 1, 32, True, 64),
    (2, 100, 8, 8, 16, True, None),           # ragged S
    (1, 64, 4, 4, 128, False, None),          # non-causal
    (1, 64, 16, 2, 8, True, 16),              # deep GQA + window
    (1, 640, 4, 1, 256, True, 512),           # gemma3-1b local layer
]
DECODE_CASES = [
    (2, 256, 4, 2, 64, None),
    (3, 100, 8, 1, 32, None),                 # ragged S
    (2, 512, 4, 4, 128, 128),                 # MHA + window
    (1, 64, 16, 2, 16, None),
    (2, 640, 4, 1, 256, 512),                 # gemma3-1b local layer
]
RMS_SHAPES = [(8, 64), (2, 17, 128), (100, 256)]


def tol(dtype: str) -> dict:
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def pair(rng, shape, dtype: str, scale: float = 1.0):
    """The same values as a jax array and a CPU torch tensor of ``dtype``."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale
                    ).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the port's oracles against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window", FLASH_CASES)
def test_flash_oracle_matches_reference(B, S, Hq, Hkv, hd, causal, window,
                                        dtype):
    rng = np.random.default_rng(1)
    qj, qt = pair(rng, (B, S, Hq, hd), dtype)
    kj, kt = pair(rng, (B, S, Hkv, hd), dtype)
    vj, vt = pair(rng, (B, S, Hkv, hd), dtype)
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    got = tref.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window", DECODE_CASES)
def test_decode_oracle_matches_reference(B, S, Hq, Hkv, hd, window, dtype):
    rng = np.random.default_rng(2)
    qj, qt = pair(rng, (B, Hq, hd), dtype)
    kj, kt = pair(rng, (B, S, Hkv, hd), dtype)
    vj, vt = pair(rng, (B, S, Hkv, hd), dtype)
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    want = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(lengths),
                                     window=window)
    got = tref.decode_attention_ref(qt, kt, vt, torch.from_numpy(lengths),
                                    window=window)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_oracle_matches_reference(shape, dtype):
    rng = np.random.default_rng(3)
    xj, xt = pair(rng, shape, dtype)
    wj, wt = pair(rng, shape[-1:], "float32", scale=0.1)
    want = jref.rmsnorm_ref(xj, wj)
    got = tref.rmsnorm_ref(xt, wt)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


# ---------------------------------------------------------------------------
# edges the kernels must reproduce
# ---------------------------------------------------------------------------
def test_global_window_is_no_window():
    rng = np.random.default_rng(4)
    _, q = pair(rng, (1, 40, 4, 16), "float32")
    _, k = pair(rng, (1, 40, 2, 16), "float32")
    _, v = pair(rng, (1, 40, 2, 16), "float32")
    assert torch.equal(
        tref.flash_attention_ref(q, k, v, window=GLOBAL_WINDOW),
        tref.flash_attention_ref(q, k, v, window=None))
    # decode rows past the cache end (length > S) included
    lengths = torch.tensor([1, 40, 90], dtype=torch.int32)
    _, qd = pair(rng, (3, 4, 16), "float32")
    _, kc = pair(rng, (3, 40, 2, 16), "float32")
    _, vc = pair(rng, (3, 40, 2, 16), "float32")
    assert torch.equal(
        tref.decode_attention_ref(qd, kc, vc, lengths, window=GLOBAL_WINDOW),
        tref.decode_attention_ref(qd, kc, vc, lengths, window=None))


@pytest.mark.parametrize("window", [None, 8])
def test_decode_length_edges_match_reference(window):
    """length == 0 (no visible key) and length > S (a row past the cache
    end, with the window taken from the unclamped length)."""
    rng = np.random.default_rng(5)
    S = 24
    qj, qt = pair(rng, (4, 4, 16), "float32")
    kj, kt = pair(rng, (4, S, 2, 16), "float32")
    vj, vt = pair(rng, (4, S, 2, 16), "float32")
    lengths = np.array([0, 1, S + 5, S + 40], np.int32)
    want = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(lengths),
                                     window=window)
    got = tref.decode_attention_ref(qt, kt, vt, torch.from_numpy(lengths),
                                    window=window)
    np.testing.assert_allclose(f32(got), f32(want), **tol("float32"))


def test_decode_length_zero_is_uniform_mean_not_pallas_zero():
    """The port follows the oracle at length == 0: the uniform mean of V
    over all S rows. The Pallas kernel returns 0 there; the port does not."""
    rng = np.random.default_rng(6)
    qj, qt = pair(rng, (2, 4, 16), "float32")
    kj, kt = pair(rng, (2, 32, 2, 16), "float32")
    vj, vt = pair(rng, (2, 32, 2, 16), "float32")
    lengths = np.array([0, 0], np.int32)
    got = f32(tref.decode_attention_ref(qt, kt, vt, torch.from_numpy(lengths)))
    mean_v = f32(vt).mean(axis=1)                      # (B, Hkv, hd)
    want = np.repeat(mean_v, 2, axis=1)                # group = 2
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)
    pallas = np.asarray(pallas_decode(qj, kj, vj, jnp.asarray(lengths),
                                      interpret=True, block_k=16))
    assert np.abs(pallas).max() == 0.0 and np.abs(got).max() > 0.0


# ---------------------------------------------------------------------------
# one small case per kernel against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
def test_flash_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    qj, qt = pair(rng, (1, 48, 4, 16), "float32")
    kj, kt = pair(rng, (1, 48, 2, 16), "float32")
    vj, vt = pair(rng, (1, 48, 2, 16), "float32")
    want = pallas_flash(qj, kj, vj, window=12, interpret=True, block_q=16,
                        block_k=16)
    got = flash_attention(qt, kt, vt, window=12)
    np.testing.assert_allclose(f32(got), f32(want), **tol("float32"))


def test_decode_matches_pallas_interpret():
    rng = np.random.default_rng(8)
    qj, qt = pair(rng, (3, 8, 16), "float32")
    kj, kt = pair(rng, (3, 64, 2, 16), "float32")
    vj, vt = pair(rng, (3, 64, 2, 16), "float32")
    lengths = np.array([1, 37, 64], np.int32)
    want = pallas_decode(qj, kj, vj, jnp.asarray(lengths), window=20,
                         interpret=True, block_k=16)
    got = decode_attention(qt, kt, vt, torch.from_numpy(lengths), window=20)
    np.testing.assert_allclose(f32(got), f32(want), **tol("float32"))


def test_rmsnorm_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    xj, xt = pair(rng, (2, 9, 64), "bfloat16")
    wj, wt = pair(rng, (64,), "float32", scale=0.1)
    want = pallas_rmsnorm(xj, wj, interpret=True, block_rows=8)
    got = rmsnorm(xt, wt)
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


# ---------------------------------------------------------------------------
# dispatch: a CPU tensor takes the plain version, never a kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["auto", "ref"])
def test_ops_cpu_tensor_takes_plain_version(mode, monkeypatch):
    monkeypatch.setenv(ops.MODE_ENV, mode)
    rng = np.random.default_rng(10)
    _, x = pair(rng, (3, 32), "float32")
    _, w = pair(rng, (32,), "float32", scale=0.1)
    _, q = pair(rng, (1, 16, 4, 8), "float32")
    _, k = pair(rng, (1, 16, 2, 8), "float32")
    _, qd = pair(rng, (1, 4, 8), "float32")
    lengths = torch.tensor([9], dtype=torch.int32)
    before = (rmsnorm.launches, flash_attention.launches,
              decode_attention.launches)
    assert ops.kernel_mode() == mode
    assert torch.equal(ops.rmsnorm(x, w), tref.rmsnorm_ref(x, w))
    assert torch.equal(ops.flash_attention(q, k, k),
                       tref.flash_attention_ref(q, k, k))
    assert torch.equal(ops.decode_attention(qd, k, k, lengths),
                       tref.decode_attention_ref(qd, k, k, lengths))
    assert (rmsnorm.launches, flash_attention.launches,
            decode_attention.launches) == before


def test_ops_cuda_mode_raises_on_cpu_tensor(monkeypatch):
    monkeypatch.setenv(ops.MODE_ENV, "cuda")
    x = torch.ones(2, 8)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        ops.rmsnorm(x, torch.zeros(8))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        ops.flash_attention(torch.ones(1, 4, 2, 8), torch.ones(1, 4, 2, 8),
                            torch.ones(1, 4, 2, 8))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        ops.decode_attention(torch.ones(1, 2, 8), torch.ones(1, 4, 2, 8),
                             torch.ones(1, 4, 2, 8),
                             torch.ones(1, dtype=torch.int32))


def test_ops_rejects_unknown_mode(monkeypatch):
    monkeypatch.setenv(ops.MODE_ENV, "pallas")
    with pytest.raises(ValueError):
        ops.kernel_mode()
    with pytest.raises(ValueError):
        ops.set_kernel_mode("interpret")
    monkeypatch.delenv(ops.MODE_ENV)
    ops.set_kernel_mode("ref")
    try:
        assert ops.kernel_mode() == "ref"
    finally:
        ops.set_kernel_mode(None)
    assert ops.kernel_mode() == "auto"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_kernel_sources_present():
    names = {p.name for p in _build.CSRC.glob("*.cu")}
    assert names == {"rmsnorm.cu", "flash_attention.cu",
                     "decode_attention.cu", "ssd_scan.cu", "rmsnorm_bwd.cu",
                     "flash_attention_bwd.cu", "ssd_scan_bwd.cu",
                     "mamba_conv.cu", "mamba_gate.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
