"""The Mamba2 mixer's two hand-written kernels on the card: ``mamba_conv``
(causal conv + bias + SiLU, dt and A) and ``mamba_gate`` (D skip + gated
RMSNorm per B/C group), each against its plain version
(``kernels/ref.py``) at mamba2-780m's and zamba2-7b's widths, on the
served column slices of one in_proj output; a wrong variant of each must
fail the same tolerance; the serving path launches each once a layer;
under autograd and on DTensors the entries run the kernels, with the
plain version's gradient. Every test is marked ``cuda`` and skips
without a GPU; the file imports neither ``jax`` nor ``repro``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda_mamba_mixer.py

Tolerances are those of tests/test_torch_cuda.py: fp32 2e-5, bf16 5e-2.
The kernels round where the plain versions round; they differ in the
order of the norm's sum and in the SiLU's exp.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.mamba_mixer import mamba_conv, mamba_gate
from repro_torch.models.programs import ModelProgram

ROOT = Path(__file__).resolve().parents[1]
DTYPES = ("float32", "bfloat16")
# d_inner, conv_dim, heads, head dim, B/C groups; in_proj = din + cd + H
WIDTHS = {"mamba2-780m": (3072, 3328, 48, 64, 1),
          "zamba2-7b": (7168, 7424, 112, 64, 2)}


def tol(dtype: str) -> dict:
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def f32(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


def beyond(got, want, dtype: str) -> int:
    """Elements of ``got`` beyond the tolerance around ``want``."""
    t = tol(dtype)
    err = (got.float() - want.float()).abs()
    return int((err > t["atol"] + t["rtol"] * want.float().abs()).sum())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the CUDA kernels")
    return torch.device("cuda")


def served(g, B, S, widths, dtype, device):
    """(z, xbc_pre, dt): column slices of one (B, S, din + cd + H)
    in_proj output, the layout the prefill hands on."""
    din, cd, H, _, _ = widths
    zxbcdt = torch.randn((B, S, din + cd + H), generator=g,
                         device=device).to(dtype)
    return (zxbcdt[..., :din], zxbcdt[..., din:din + cd],
            zxbcdt[..., din + cd:])


def mixer_params(g, widths, k, dtype, device):
    din, cd, H, _, _ = widths
    rn = lambda *s: torch.randn(s, generator=g, device=device)
    return dict(conv_w=(rn(k, cd) * 0.5).to(dtype), conv_b=(rn(cd) * 0.3)
                .to(dtype), dt_bias=(rn(H) - 2.0).to(dtype),
                A_log=(rn(H) * 0.5 + 1.0).to(dtype), D=rn(H).to(dtype),
                norm=(rn(din) * 0.1).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", list(WIDTHS))
@pytest.mark.parametrize("B,S", [(1, 1), (1, 3), (1, 257), (1, 4000),
                                 (2, 300)])
def test_mamba_conv_matches_plain(cuda, model, B, S, dtype):
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    _, xbc, dt = served(g, B, S, WIDTHS[model], dt_, cuda)
    p = mixer_params(g, WIDTHS[model], 4, dt_, cuda)
    args = (xbc, dt, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"])
    n = mamba_conv.launches
    got = mamba_conv(*args)
    assert mamba_conv.launches == n + 1
    want = ref.mamba_conv_ref(*args)
    assert [t.dtype for t in got] == [dt_, torch.float32, torch.float32]
    np.testing.assert_allclose(f32(got[0]), f32(want[0]), **tol(dtype))
    for a, b in zip(got[1:], want[1:]):      # dt and A: fp32 from the same
        np.testing.assert_allclose(f32(a), f32(b), **tol("float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,C,H,offset", [(2, 40, 3, 0), (3, 37, 5, 1),
                                          (4, 24, 2, 3), (8, 64, 4, 0)])
def test_mamba_conv_odd_shapes_and_widths(cuda, k, C, H, offset, dtype):
    """Conv widths 2-8; a channel count and a row stride that hold no
    whole 16-byte pieces (one channel a thread); S < k - 1 included."""
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(k)
    for S in (1, 5, 70):
        buf = torch.randn((2, S, offset + C + H + 1), generator=g,
                          device=cuda).to(dt_)
        xbc, dt = buf[..., offset:offset + C], buf[..., offset + C:-1]
        w = torch.randn((k, C), generator=g, device=cuda).to(dt_)
        b, dtb, alog = (torch.randn((n,), generator=g, device=cuda)
                        for n in (C, H, H))
        got = mamba_conv(xbc, dt, w, b, dtb, alog)
        want = ref.mamba_conv_ref(xbc, dt, w, b, dtb, alog)
        np.testing.assert_allclose(f32(got[0]), f32(want[0]), **tol(dtype))
        np.testing.assert_allclose(f32(got[1]), f32(want[1]),
                                   **tol("float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", list(WIDTHS))
@pytest.mark.parametrize("lead", [(1, 1), (1, 3), (1, 257), (1, 4000),
                                  (16,)])           # prefill rows, decode
def test_mamba_gate_matches_plain(cuda, model, lead, dtype):
    dt_ = getattr(torch, dtype)
    din, cd, H, P, G = WIDTHS[model]
    g = torch.Generator(device=cuda).manual_seed(1)
    zx = torch.randn(lead + (din + cd + H,), generator=g,
                     device=cuda).to(dt_)
    z = zx[..., :din]
    x = zx[..., din:2 * din].unflatten(-1, (H, P))     # xbc's x columns
    y = torch.randn(lead + (H, P), generator=g, device=cuda).to(dt_)
    p = mixer_params(g, WIDTHS[model], 4, dt_, cuda)
    args = (y, x, p["D"], z, p["norm"], 1e-5, G)
    n = mamba_gate.launches
    got = mamba_gate(*args)
    assert mamba_gate.launches == n + 1
    assert got.shape == lead + (din,) and got.dtype == dt_
    np.testing.assert_allclose(f32(got), f32(ref.mamba_gate_ref(*args)),
                               **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,P,G,w_dtype", [
    (5, 3, 1, "float32"),         # a head of 3: one channel a thread
    (4, 16, 4, "float32"),        # four groups of 16
    (2, 8, 2, "bfloat16"),
    (64, 512, 1, "bfloat16")])    # a group of 32,768: past the buckets
def test_mamba_gate_odd_widths_groups_and_weight_types(cuda, H, P, G,
                                                        w_dtype, dtype):
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(2)
    din = H * P
    for lead in ((3, 7), (2,)):
        y, x = (torch.randn(lead + (H, P), generator=g, device=cuda).to(dt_)
                for _ in range(2))
        z = torch.randn(lead + (din,), generator=g, device=cuda).to(dt_)
        D = torch.randn((H,), generator=g, device=cuda)
        w = (torch.randn((din,), generator=g, device=cuda) * 0.1).to(
            getattr(torch, w_dtype))
        got = mamba_gate(y, x, D, z, w, 1e-5, G)
        np.testing.assert_allclose(
            f32(got), f32(ref.mamba_gate_ref(y, x, D, z, w, 1e-5, G)),
            **tol(dtype))


@pytest.mark.cuda
def test_wrong_variants_fail_the_tolerance(cuda):
    """The tolerance tells each kernel from a wrong one: the conv without
    its causal shift (the taps over rows s .. s + k - 1), and the two
    groups normalised as one (the groups at scales 1 and 4, as a
    mixture's groups can be)."""
    bf16 = torch.bfloat16
    widths = WIDTHS["zamba2-7b"]
    din, cd, H, P, G = widths
    g = torch.Generator(device=cuda).manual_seed(3)
    z, xbc, dt = served(g, 1, 700, widths, bf16, cuda)
    p = mixer_params(g, widths, 4, bf16, cuda)
    got = mamba_conv(xbc, dt, p["conv_w"], p["conv_b"], p["dt_bias"],
                     p["A_log"])[0]
    k = p["conv_w"].shape[0]
    ahead = F.pad(xbc, (0, 0, 0, k - 1))
    wrong = F.silu(sum(ahead[:, i:i + 700] * p["conv_w"][i]
                       for i in range(k)) + p["conv_b"])
    assert beyond(got, wrong, "bfloat16") > 0
    assert beyond(got, ref.causal_conv_ref(xbc, p["conv_w"], p["conv_b"]),
                  "bfloat16") == 0
    y = torch.randn((1, 700, H, P), generator=g, device=cuda)
    y[..., H // G:, :] *= 4.0
    y = y.to(bf16)
    x = got[..., :din].unflatten(-1, (H, P))
    out = mamba_gate(y, x, p["D"], z, p["norm"], 1e-5, G)
    wrong = ref.mamba_gate_ref(y, x, p["D"], z, p["norm"], 1e-5, 1)
    assert beyond(out, wrong, "bfloat16") > 0
    assert beyond(out, ref.mamba_gate_ref(y, x, p["D"], z, p["norm"], 1e-5,
                                          G), "bfloat16") == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_runs_the_kernels_with_the_plain_gradient(cuda, dtype):
    """Under autograd each ops entry launches its kernel once, its output
    is the kernel's under no_grad, and, for the same output gradients,
    every input's gradient is autograd's of the plain version."""
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(4)
    widths = WIDTHS["zamba2-7b"]
    din, cd, H, P, G = widths
    z, xbc, dt = served(g, 2, 300, widths, dt_, cuda)
    p = mixer_params(g, widths, 4, dt_, cuda)
    y = torch.randn((2, 300, H, P), generator=g, device=cuda).to(dt_)
    x = xbc[..., :din].unflatten(-1, (H, P))
    cases = [("mamba_conv", (xbc, dt, p["conv_w"], p["conv_b"],
                             p["dt_bias"], p["A_log"]), ()),
             ("mamba_gate", (y, x, p["D"], z, p["norm"]), (1e-5, G))]
    for name, ins, consts in cases:
        leaves = [t.detach().clone().requires_grad_() for t in ins]
        n = ops.launch_counts()[name]
        outs = getattr(ops, name)(*leaves, *consts)
        assert ops.launch_counts()[name] == n + 1
        outs = outs if isinstance(outs, tuple) else (outs,)
        with torch.no_grad():
            kern = getattr(ops, name)(*ins, *consts)
        kern = kern if isinstance(kern, tuple) else (kern,)
        assert all(torch.equal(a, b) for a, b in zip(outs, kern))
        seeds = [torch.randn(o.shape, generator=g, device=cuda).to(o.dtype)
                 for o in outs]
        torch.autograd.backward(outs, seeds)
        plain = [t.detach().clone().requires_grad_() for t in ins]
        want = getattr(ref, name + "_ref")(*plain, *consts)
        want = want if isinstance(want, tuple) else (want,)
        torch.autograd.backward(want, seeds)
        for got, ref_leaf in zip(leaves, plain):
            assert got.grad is not None
            np.testing.assert_allclose(f32(got.grad), f32(ref_leaf.grad),
                                       **tol(dtype))


MESH_OF_ONE = """
    import json, sys
    import torch
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{sys.argv[1]}",
                            rank=0, world_size=1)
    torch.cuda.set_device(0)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.kernels import ops
    mesh = init_device_mesh("cuda", (1,))
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, P, N, k = 2, 40, 8, 16, 16, 4
    din, cd = H * P, H * P + 2 * N
    rn = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    t = dict(xbc=rn(B, S, cd), dt=rn(B, S, H), w=rn(k, cd), b=rn(cd),
             dt_bias=rn(H), A_log=rn(H), y=rn(B, S, H, P), x=rn(B, S, H, P),
             D=rn(H), z=rn(B, S, din), nw=rn(din))
    d = {n: distribute_tensor(v, mesh, [Shard(0)]).requires_grad_()
         for n, v in t.items()}
    res = {}
    for name, names, consts in [
            ("mamba_conv", ("xbc", "dt", "w", "b", "dt_bias", "A_log"), ()),
            ("mamba_gate", ("y", "x", "D", "z", "nw"), (1e-5, 1))]:
        n = ops.launch_counts()[name]
        got = getattr(ops, name)(*[d[v] for v in names], *consts)
        res[name + "_launches"] = ops.launch_counts()[name] - n
        with torch.no_grad():
            want = getattr(ops, name)(*[t[v] for v in names], *consts)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        res[name + "_equal"] = all(torch.equal(a.full_tensor(), b)
                                   for a, b in zip(got, want))
        sum(o.float().pow(2).sum() for o in got).backward()
        res[name + "_grads"] = all(d[v].grad is not None for v in names)
    print(json.dumps(res))
    dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_dtensors_on_the_card_run_the_kernels(cuda, tmp_path):
    """On a mesh of one card (nccl) the entries launch their kernels on
    the local tensors, under autograd, and give the plain tensors'
    kernel results bit for bit."""
    script = tmp_path / "mesh.py"
    script.write_text(textwrap.dedent(MESH_OF_ONE))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(script), str(port)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res == {"mamba_conv_launches": 1, "mamba_conv_equal": True,
                   "mamba_conv_grads": True, "mamba_gate_launches": 1,
                   "mamba_gate_equal": True, "mamba_gate_grads": True}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("mamba2-780m", 6),
                                         ("zamba2-2.7b", 6),
                                         ("zamba2-7b-instruct", 8)])
def test_serving_path_launches_each_kernel_once_a_layer(cuda, arch, layers,
                                                        monkeypatch):
    """A prefill adds ``n_layers`` to each kernel's count and a decode step
    ``n_layers`` to ``mamba_gate``'s, eager, captured or replayed; the
    graph batcher's tokens are the eager batcher's."""
    from repro_torch.core import ContinuousBatcher, HydraRuntime, LMSpec
    from repro_torch.core import scheduler
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    if cfg.published_hybrid:
        cfg = dataclasses.replace(cfg, hybrid_layer_ids=(2, 5))
    params = ModelProgram(cfg).init(0, device=cuda, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (1, 300), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(5))
    with torch.no_grad():
        before = ops.launch_counts()
        _, cache = tf.prefill(params, cfg, tokens)
        mid = ops.launch_counts()
        tf.decode_step(params, cfg, cache, tokens[:, :1])
        after = ops.launch_counts()
    assert mid["mamba_conv"] - before["mamba_conv"] == layers
    assert mid["mamba_gate"] - before["mamba_gate"] == layers
    assert after["mamba_conv"] == mid["mamba_conv"]
    assert after["mamba_gate"] - mid["mamba_gate"] == layers

    rt = HydraRuntime(device=cuda, memory_budget_bytes=1 << 40,
                      n_workers=0, janitor=False)
    try:
        spec = LMSpec(cfg=cfg, params=params, max_seq=1024, slots=4)
        for fid in ("eager", "graph"):
            rt.register_function(fid, spec)
        rng = np.random.default_rng(6)
        sched = [(3 * i, rng.integers(0, cfg.vocab_size,
                                      int(rng.integers(40, 700))).tolist(),
                  int(rng.integers(3, 13))) for i in range(8)]

        def serve(b):
            todo, futs, t, seen = list(sched), [], 0, []
            decode = b._decode

            def counted():
                n0 = ops.launch_counts()["mamba_gate"]
                out = decode()
                seen.append(ops.launch_counts()["mamba_gate"] - n0)
                return out
            b._decode = counted
            while todo or b.active or b.pending:
                while todo and todo[0][0] <= t:
                    futs.append(b.submit(*todo.pop(0)[1:]))
                b.step()
                t += 1
            return [f.result() for f in futs], seen

        with monkeypatch.context() as m:
            m.setattr(scheduler, "_graphs_on", lambda device: False)
            eager = ContinuousBatcher(rt, "eager")
        want, seen_e = serve(eager)
        graph = ContinuousBatcher(rt, "graph")
        got, seen_g = serve(graph)
        assert got == want
        assert rt.metrics.counters["decode_graph.replays"] >= 10
        assert set(seen_e) == set(seen_g) == {layers}
        for b in (eager, graph):
            b.close()
    finally:
        rt.shutdown()
