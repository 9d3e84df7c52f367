"""The published Zamba2 block's kernels and serving path on the card:
the SSD scan with two B/C groups, flash and decode attention at head dim
224, one group unchanged by the groups' code, and a full-width
Zamba2-7B-Instruct cut in depth served through the runtime with the
decode graph. Every test is marked ``cuda`` and skips without a GPU; the
file imports neither ``jax`` nor ``repro``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda_zamba2.py

Tolerances are those of tests/test_torch_cuda.py: fp32 2e-5, bf16 5e-2,
and 1e-3 for the SSD scan's fp32 final state.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.programs import ModelProgram

DTYPES = ("float32", "bfloat16")
SCALE = 112 ** -0.5                          # (224 / 2)^-1/2


def tol(dtype: str) -> dict:
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def f32(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the CUDA kernels")
    return torch.device("cuda")


def grouped_inputs(g, B, S, H, P, N, G, dtype, device):
    rn = lambda *shape: torch.randn(shape, generator=g, device=device)
    x = rn(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H))
    A = -torch.exp(rn(H) * 0.3)
    Bm = (rn(B, S, G, N) * 0.5).to(dtype)
    Cm = (rn(B, S, G, N) * 0.5).to(dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,N,G,chunk", [
    (1, 2500, 112, 64, 64, 2, 256),           # zamba2-7b's prefill
    (1, 1024, 112, 64, 64, 2, 256),           # its shortest prompt
    (2, 300, 8, 64, 32, 4, 128),              # four groups, two chunks
    (1, 77, 6, 16, 16, 3, 32)])               # ragged, N not 64
def test_ssd_scan_groups_match_plain(cuda, B, S, H, P, N, G, chunk, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x, dt, A, Bm, Cm = grouped_inputs(g, B, S, H, P, N, G,
                                      getattr(torch, dtype), cuda)
    n = ssd_scan.launches
    y, sf = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, return_state=True)
    assert ssd_scan.launches == n + 1
    yr, sr = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                              return_state=True)
    np.testing.assert_allclose(f32(y), f32(yr), **tol(dtype))
    np.testing.assert_allclose(f32(sf), f32(sr), atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_one_group_is_the_scan_it_was(cuda, dtype):
    """One group as (B,S,N) or (B,S,1,N), and two groups holding the same
    B and C, give the same bits: the groups' code changes nothing the
    heads compute."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x, dt, A, Bm, Cm = grouped_inputs(g, 1, 700, 16, 64, 64, 1,
                                      getattr(torch, dtype), cuda)
    y3, s3 = ssd_scan(x, dt, A, Bm[:, :, 0], Cm[:, :, 0], chunk=256,
                      return_state=True)
    y4, s4 = ssd_scan(x, dt, A, Bm, Cm, chunk=256, return_state=True)
    y2, s2 = ssd_scan(x, dt, A, Bm.expand(-1, -1, 2, -1),
                      Cm.expand(-1, -1, 2, -1), chunk=256, return_state=True)
    assert torch.equal(y3, y4) and torch.equal(s3, s4)
    assert torch.equal(y3, y2) and torch.equal(s3, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_reads_grouped_column_slices(cuda, dtype):
    """The serving layout: x, B (B,S,G,N) and C as views of one
    (B, S, H*P + 2GN) projection."""
    g = torch.Generator(device=cuda).manual_seed(2)
    B, S, H, P, N, G = 1, 600, 16, 64, 64, 2
    xbc = torch.randn((B, S, H * P + 2 * G * N), generator=g,
                      device=cuda).to(getattr(torch, dtype))
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm = xbc[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    Cm = xbc[..., H * P + G * N:].unflatten(-1, (G, N))
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g,
                                                  device=cuda))
    A = -torch.exp(torch.randn((H,), generator=g, device=cuda) * 0.3)
    y = ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    yc = ssd_scan(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(),
                  chunk=256)
    assert torch.equal(y, yc)
    np.testing.assert_allclose(f32(y), f32(ref.ssd_scan_ref(
        x, dt, A, Bm, Cm, chunk=256)), **tol(dtype))


@pytest.mark.cuda
def test_grouped_scan_backward_is_refused(cuda):
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    g = torch.Generator(device=cuda).manual_seed(3)
    x, dt, A, Bm, Cm = grouped_inputs(g, 1, 64, 4, 16, 16, 2,
                                      torch.bfloat16, cuda)
    with pytest.raises(NotImplementedError, match="groups"):
        ssd_scan_bwd(torch.ones_like(x), x, dt, A, Bm, Cm, chunk=64,
                     saved=(None, None))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H", [(1, 2500, 32), (1, 333, 32),
                                   (2, 100, 4)])
def test_flash_attention_at_head_dim_224(cuda, B, S, H, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((B, S, H, 224), generator=g, device=cuda).to(dt)
               for _ in range(3))
    n = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, scale=SCALE)
    assert flash_attention.launches == n + 1
    want = ref.flash_attention_ref(q, k, v, causal=True, scale=SCALE)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,lengths", [
    (16, 4096, [1024, 4000, 2500, 1, 0, 4096, 3000, 2048] * 2),
    (3, 1000, [999, 17, 640])])
def test_decode_attention_at_head_dim_224(cuda, B, S, lengths, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn((B, 32, 224), generator=g, device=cuda).to(dt)
    kc, vc = (torch.randn((B, S, 32, 224), generator=g, device=cuda).to(dt)
              for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n = decode_attention.launches
    got = decode_attention(q, kc, vc, lens, scale=SCALE)
    assert decode_attention.launches == n + 1
    want = ref.decode_attention_ref(q, kc, vc, lens, scale=SCALE)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


def _cut(layers: int = 12, ids=(6, 11)):
    """Zamba2-7B-Instruct at full width, ``layers`` deep, two invocations
    (both shared blocks)."""
    return dataclasses.replace(get_config("zamba2-7b-instruct"),
                               n_layers=layers, hybrid_layer_ids=ids)


@pytest.mark.cuda
def test_full_width_cut_serves_through_the_decode_graph(cuda, monkeypatch):
    """The batcher's tokens with the decode graph equal its eager steps'
    over a schedule with admissions between decodes; after the capture
    every step replays."""
    from repro_torch.core import ContinuousBatcher, HydraRuntime, LMSpec
    from repro_torch.core import scheduler
    cfg = _cut()
    rt = HydraRuntime(device=cuda, memory_budget_bytes=1 << 40,
                      n_workers=0, janitor=False)
    spec = LMSpec(cfg=cfg, params=ModelProgram(cfg).init(
        0, device=cuda, dtype=torch.bfloat16), max_seq=1024, slots=4)
    for fid in ("eager", "graph"):
        rt.register_function(fid, spec)
    rng = np.random.default_rng(3)
    sched = [(3 * i, rng.integers(0, cfg.vocab_size,
                                  int(rng.integers(40, 700))).tolist(),
              int(rng.integers(3, 13))) for i in range(10)]

    def serve(b):
        todo, futs, t = list(sched), [], 0
        while todo or b.active or b.pending:
            while todo and todo[0][0] <= t:
                futs.append(b.submit(*todo.pop(0)[1:]))
            b.step()
            t += 1
        return [f.result() for f in futs]

    try:
        with monkeypatch.context() as m:
            m.setattr(scheduler, "_graphs_on", lambda device: False)
            eager = ContinuousBatcher(rt, "eager")
        want = serve(eager)
        graph = ContinuousBatcher(rt, "graph")
        got = serve(graph)
        assert got == want and graph.steps == eager.steps >= 30
        c = rt.metrics.counters
        assert c["decode_graph.captures"] == 1
        assert c["decode_graph.replays"] == graph.steps - 1
        assert c["lm_slab_bytes.kv"] == 2 * 2 * 2 * 4 * 1024 * 32 * 224 * 2
        for b in (eager, graph):
            b.close()
    finally:
        rt.shutdown()


@pytest.mark.cuda
def test_full_width_cut_prefill_is_the_plain_model(cuda):
    """bf16 prefill logits of the full-width cut against the float32 model
    written from transformers' code, on the card: within bf16's reach
    (relative RMS)."""
    sys.path.insert(0, str(Path(__file__).parent))
    import zamba2_reference as z2ref
    cfg = _cut(layers=8, ids=(2, 5))
    params = ModelProgram(cfg).init(1, device=cuda, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (1, 700), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(2))
    from repro_torch.models import transformer as tf
    with torch.no_grad():
        got = tf.forward(params, cfg, tokens)[0][0].float()
        want = z2ref.logits(params, cfg, tokens[0])
    rel = float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    assert rel < 0.05, rel
