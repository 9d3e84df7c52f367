"""The plain reference against the port at a reduced size, float32, on
the same weights (the benchmark's own, from a seed)."""
from __future__ import annotations

import hashlib

import pytest
import torch

from portbench import weights
from portbench.conftest import SSM
from portbench.program import arch_config
from portbench.reference import ssm
from portbench.reference.layers import matmul
from portbench.registry import Registry

REG = Registry()


@pytest.mark.parametrize("S", [37, 8, 1])
def test_ssd_against_the_recurrence(S):
    g = torch.Generator().manual_seed(S)
    B, H, P, N = 2, 3, 4, 5
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.rand(H, generator=g) * 2
    Bm, Cm = (torch.randn(B, S, N, generator=g) for _ in range(2))
    y = ssm.ssd(x, dt, A, Bm, Cm, chunk=8)
    h = torch.zeros(B, H, P, N, dtype=torch.float64)
    for t in range(S):
        dec = torch.exp(dt[:, t].double() * A.double())
        h = h * dec[..., None, None] + (dt[:, t, :, None, None].double()
                                        * x[:, t, :, :, None].double()
                                        * Bm[:, t, None, None, :].double())
        want = torch.einsum("bhpn,bn->bhp", h, Cm[:, t].double())
        torch.testing.assert_close(y[:, t].double(), want, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("tied,S", [(True, 21), (False, 21), (True, 8)],
                         ids=["tied", "untied", "one-chunk"])
def test_model_against_the_port(tied, S):
    from repro_torch.models import transformer as tf
    cfg = dict(SSM, dtype="float32", tie_embeddings=tied)
    params = weights.make(REG, cfg, 2**31 + 7, torch.float32, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (2, S),
                           generator=torch.Generator().manual_seed(1))
    port = tf.forward(params, arch_config(cfg), tokens)[0]
    ref = ssm.logits(params, cfg, tokens)
    torch.testing.assert_close(ref, port, rtol=1e-4, atol=1e-4)
    rows = ssm.logits(params, cfg, tokens, rows=slice(5, S))
    torch.testing.assert_close(rows, ref[:, 5:S])


def test_fp8_products_differ_from_fp32_by_fp8_rounding():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(16, 64, generator=g), torch.randn(64, 32, generator=g)
    exact, low = matmul(x, w, "fp32"), matmul(x, w, "fp8")
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.1        # e4m3: 3 mantissa bits


def test_weights_remade_leaf_by_leaf():
    cfg = dict(SSM, tie_embeddings=False)
    tree = weights.make(REG, cfg, 5, torch.float32, "cpu")
    flat = weights.flatten(tree)
    layout = weights.layout(REG, cfg)
    assert layout == ssm.shapes(cfg)
    assert list(flat) == list(layout)
    for path, t in flat.items():
        assert torch.equal(t, weights.make_leaf(5, path, layout[path],
                                                torch.float32, "cpu"))
    other = weights.make_leaf(6, "layers.ssm.in_proj",
                              layout["layers.ssm.in_proj"], torch.float32,
                              "cpu")
    assert not torch.equal(other, flat["layers.ssm.in_proj"])
    A = -torch.exp(flat["layers.ssm.A_log"])
    assert float(A.max()) <= -1.0 and float(A.min()) >= -16.0


# sha256 of the reduced ``ssm`` tree (path, shape, dtype and bytes of each
# leaf, in tree order) at seed 2**31 + 7, as the weights were made before
# the layout moved to ``reference/ssm.py``: paths, order, kinds and seeds
# are the served configurations' too
PARENT_DIGESTS = {
    (True, "float32"):
        "62c7719be9af3dd57779ca3ba3bf88217751d3016ae9f633e1c4dc434c9ea023",
    (True, "bfloat16"):
        "379f4480bdde7d3f4df2432eac9a94f2c99fe0cbc8d1b433de0e64d573507fe1",
    (False, "float32"):
        "281d34fc4457e96759714166ab218a029dd42e292c3a6b5568c6204e01cd6275",
    (False, "bfloat16"):
        "1a7f5a728c5d98e7aefa6aeb6ac34e98213ea1bd9ef6b21f806cb8f71e70a428",
}


@pytest.mark.parametrize("tied,dtype", list(PARENT_DIGESTS),
                         ids=[f"{'tied' if t else 'untied'}-{d}"
                              for t, d in PARENT_DIGESTS])
def test_ssm_weights_are_bitwise_as_pinned(tied, dtype):
    cfg = dict(SSM, tie_embeddings=tied)
    flat = weights.flatten(weights.make(REG, cfg, 2**31 + 7,
                                        getattr(torch, dtype), "cpu"))
    h = hashlib.sha256()
    for path, t in flat.items():
        h.update(f"{path}:{tuple(t.shape)}:{t.dtype}".encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == PARENT_DIGESTS[tied, dtype]
