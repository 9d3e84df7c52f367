"""The Mamba2 mixer's elementwise chain as ``kernels/ops`` entries
(``mamba_conv``, ``mamba_gate``) on the CPU.

Their plain versions (``kernels/ref.py`` ``mamba_conv_ref``,
``mamba_gate_ref``), which the CPU route takes, are held to the JAX
package's jnp chain (``repro/models/ssm.py``: ``_causal_conv``, dt and A,
the D skip and ``_gated_norm``, applied per B/C group at two groups) in
fp32 and bf16, on the served column slices of one in_proj output and at
S < k - 1; so are ``mamba_prefill`` and ``mamba_decode`` there, and the
prefill's gradients under autograd. ``MambaConvFn`` and ``MambaGateFn``,
the kernel route under autograd, give the plain version's gradients bit
for bit (their forward is the plain version on the CPU), and the mixer
takes them wherever a tensor under autograd takes the kernel route.
DTensors over two gloo ranks keep the batch split and match the plain
version, values and gradients. The CUDA kernels are held to the plain
versions on the card by tests/test_torch_cuda_mamba_mixer.py.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels import mamba_mixer, ops, ref
from repro_torch.models import ssm
from repro_torch.models.programs import ModelProgram

ROOT = Path(__file__).resolve().parents[1]
DTYPES = (torch.float32, torch.bfloat16)
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}


def _j(t: torch.Tensor):
    """``t`` as a jax array of its dtype (bf16 carried through fp32, which
    holds it exactly)."""
    a = jnp.asarray(t.detach().float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got: torch.Tensor, want, dtype) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               **TOL[dtype])


# ---------------------------------------------------------------------------
def _cfg(groups: int):
    cfg = get_config("mamba2-780m").reduced()
    return dataclasses.replace(cfg, ssm_groups=groups) if groups > 1 else cfg


def _layer(cfg, dtype, seed=0):
    """One layer's mixer params with nonzero biases, D, norm and A_log (the
    init's zeros and ones would hide a misplaced term)."""
    gen = torch.Generator().manual_seed(seed)
    p = ssm.init_mamba(gen, cfg)
    for k in ("conv_b", "A_log", "dt_bias", "norm", "D"):
        p[k] = p[k] + 0.3 * torch.randn(p[k].shape, generator=gen)
    return {k: v.to(dtype) for k, v in p.items()}


def _served(cfg, p, B, S, dtype, seed=1):
    """z, xbc_pre, dt: the column slices of one in_proj output, as the
    prefill hands them on."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, cfg.d_model), generator=gen).to(dtype)
    return ssm._split_proj(x @ p["in_proj"], cfg)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("S", [2, 11])             # 2 < k - 1 = 3
def test_mamba_conv_matches_the_jnp_chain(dtype, groups, S):
    cfg = _cfg(groups)
    p = _layer(cfg, dtype)
    _, xbc_pre, dt = _served(cfg, p, 2, S, dtype)
    assert xbc_pre.stride(1) != xbc_pre.shape[2]      # a column slice
    xbc, dt_out, A = ops.mamba_conv(xbc_pre, dt, p["conv_w"], p["conv_b"],
                                    p["dt_bias"], p["A_log"])
    assert xbc.dtype == dtype and dt_out.dtype == A.dtype == torch.float32
    _close(xbc, jssm._causal_conv(_j(xbc_pre), _j(p["conv_w"]),
                                  _j(p["conv_b"])), dtype)
    _close(dt_out, jax.nn.softplus(_j(dt).astype(jnp.float32)
                                   + _j(p["dt_bias"]).astype(jnp.float32)),
           torch.float32)
    _close(A, -jnp.exp(_j(p["A_log"]).astype(jnp.float32)), torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("lead", [(2, 11), (3,)])  # prefill rows, decode
def test_mamba_gate_matches_the_jnp_chain(dtype, groups, lead):
    """The D skip and ``_gated_norm``, the latter applied to each group's
    d_inner / G channels on their own."""
    cfg = _cfg(groups)
    p = _layer(cfg, dtype)
    H, P, din = cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_inner
    gen = torch.Generator().manual_seed(2)
    y = torch.randn(lead + (H, P), generator=gen).to(dtype)
    xbc = torch.randn(lead + (ssm.conv_dim(cfg),), generator=gen).to(dtype)
    x = xbc[..., :din].unflatten(-1, (H, P))           # a column slice
    z = torch.randn(lead + (2 * din,), generator=gen).to(dtype)[..., :din]
    got = ops.mamba_gate(y, x, p["D"], z, p["norm"], cfg.norm_eps, groups)
    assert got.dtype == dtype and got.shape == lead + (din,)
    jy = _j(y) + _j(p["D"]).astype(_j(x).dtype)[:, None] * _j(x)
    by_group = lambda a: a.reshape(a.shape[:-1] + (groups, din // groups))
    want = jssm._gated_norm(by_group(jy.reshape(lead + (din,))),
                            by_group(_j(z)), by_group(_j(p["norm"])),
                            cfg.norm_eps)
    _close(got, want.reshape(lead + (din,)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_prefill_shorter_than_the_conv_window_matches_reference(dtype):
    """A 2-token prefill (S < k - 1) and a decode step after it against
    the JAX package's mixer, one B/C group."""
    cfg = _cfg(1)
    jcfg = dataclasses.replace(jget_config("mamba2-780m").reduced(),
                               dtype=str(dtype).removeprefix("torch."))
    p = _layer(cfg, dtype, seed=3)
    jp = {k: _j(v) for k, v in p.items()}
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 3, cfg.d_model), generator=gen).to(dtype)
    out, (conv, st) = ssm.mamba_prefill(p, x[:, :2], cfg, return_state=True)
    jout, (jconv, jst) = jssm.mamba_prefill(jp, _j(x[:, :2]), jcfg,
                                            return_state=True)
    _close(out, jout, dtype)
    _close(conv, jconv, dtype)
    _close(st, jst, dtype)
    o1 = ssm.mamba_decode(p, x[:, 2:], cfg, conv, st)
    jo1, _, _ = jssm.mamba_decode(jp, _j(x[:, 2:]), jcfg, jconv, jst)
    _close(o1, jo1, dtype)


def _entry_inputs(entry: str, dtype):
    """One entry's tensor inputs on the served slices, and its constants."""
    cfg = _cfg(2)
    p = _layer(cfg, dtype, seed=7)
    z, xbc_pre, dt = _served(cfg, p, 2, 9, dtype, seed=8)
    if entry == "mamba_conv":
        return (xbc_pre, dt, p["conv_w"], p["conv_b"], p["dt_bias"],
                p["A_log"]), ()
    H, P, din = cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_inner
    y = torch.randn((2, 9, H, P), generator=torch.Generator().manual_seed(9))
    return (y.to(dtype), xbc_pre[..., :din].unflatten(-1, (H, P)), p["D"], z,
            p["norm"]), (cfg.norm_eps, cfg.ssm_groups)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("entry", ["mamba_conv", "mamba_gate"])
def test_kernel_functions_differentiate_the_plain_version(entry, dtype):
    """The kernel route's Functions: the output and, for the same output
    gradients, every input's gradient equal the plain version's under
    autograd bit for bit (on the CPU their forward is the plain version;
    the backward recomputes it from the saved inputs)."""
    fn = {"mamba_conv": mamba_mixer.MambaConvFn,
          "mamba_gate": mamba_mixer.MambaGateFn}[entry]
    plain = getattr(ref, entry + "_ref")
    ins, consts = _entry_inputs(entry, dtype)

    def run(f):
        leaves = [t.detach().clone().requires_grad_() for t in ins]
        outs = f(*leaves, *consts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        gen = torch.Generator().manual_seed(10)
        seeds = [torch.randn(o.shape, generator=gen).to(o.dtype)
                 for o in outs]
        torch.autograd.backward(outs, seeds)
        return outs, [t.grad for t in leaves]

    got, want = run(fn.apply), run(plain)
    for g, w in zip(got[0] + tuple(got[1]), want[0] + tuple(want[1])):
        assert g is not None and g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("entry", ["mamba_conv", "mamba_gate"])
def test_autograd_on_the_kernel_route_takes_the_functions(monkeypatch,
                                                          entry):
    """Where a tensor under autograd takes the kernel route (a CUDA tensor
    on the card; here ``_needs_grad`` is told that every tensor is one),
    the entry runs through its Function, and its output and gradients are
    those of the plain route, bit for bit."""
    ins, consts = _entry_inputs(entry, torch.float32)

    def run():
        leaves = [t.detach().clone().requires_grad_() for t in ins]
        outs = getattr(ops, entry)(*leaves, *consts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum(o.pow(2).sum() for o in outs).backward()
        return list(outs) + [t.grad for t in leaves]

    want = run()
    fn = {"mamba_conv": mamba_mixer.MambaConvFn,
          "mamba_gate": mamba_mixer.MambaGateFn}[entry]
    calls = []
    real = fn.apply
    monkeypatch.setattr(fn, "apply",
                        lambda *a: (calls.append(entry), real(*a))[1])
    monkeypatch.setattr(ops, "_needs_grad", lambda t, *more: (
        torch.is_grad_enabled()
        and any(u.requires_grad for u in (t,) + more)))
    got = run()
    assert calls == [entry]
    for g, w in zip(got, want):
        assert g is not None and torch.equal(g, w)


def test_cpu_route_launches_nothing_and_spans_each_entry(monkeypatch):
    """The CPU route is the plain version: no launch counted, and each
    entry is one ``kernel`` span of its own name."""
    from repro_torch.kernels import ops as ops_mod
    names = []

    def recording(kind, name=None):
        names.append((kind, name))
        return contextlib.nullcontext()
    monkeypatch.setattr(ops_mod, "step_span", recording)
    cfg = _cfg(2)
    p = _layer(cfg, torch.bfloat16)
    before = ops.launch_counts()
    x = torch.randn((1, 5, cfg.d_model)).to(torch.bfloat16)
    ssm.mamba_prefill(p, x, cfg)
    assert ops.launch_counts() == before
    assert before["mamba_conv"] == mamba_mixer.mamba_conv.launches
    assert before["mamba_gate"] == mamba_mixer.mamba_gate.launches
    kernels = [n for k, n in names if k == "kernel"]
    assert kernels == ["mamba_conv", "ssd_scan", "mamba_gate"]


@pytest.mark.parametrize("mode", ["auto", "ref"])
def test_autograd_takes_the_plain_composition(mode):
    """On the CPU under autograd the entries are the plain composition:
    every gradient of a prefill's loss matches ``jax.grad`` of the JAX
    package's mixer (max |dg| / max |g| within 2e-5, fp32)."""
    cfg = _cfg(1)
    jcfg = dataclasses.replace(jget_config("mamba2-780m").reduced(),
                               dtype="float32")
    p = _layer(cfg, torch.float32, seed=5)
    x = torch.randn((2, 9, cfg.d_model),
                    generator=torch.Generator().manual_seed(6))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xx = x.clone().requires_grad_()
    ops.set_kernel_mode(mode)
    try:
        ssm.mamba_prefill(leaves, xx, cfg)[0].pow(2).sum().backward()
    finally:
        ops.set_kernel_mode(None)

    def loss(jp, jx):
        return jnp.sum(jnp.square(jssm.mamba_prefill(jp, jx, jcfg)[0]))
    jg, jgx = jax.grad(loss, argnums=(0, 1))(
        {k: _j(v) for k, v in p.items()}, _j(x))
    for got, want in [(xx.grad, jgx)] + [(leaves[k].grad, jg[k])
                                         for k in sorted(p)]:
        assert got is not None
        w = _np(want)
        err = float(np.abs(got.numpy() - w).max()) / max(
            float(np.abs(w).max()), 1e-30)
        assert err <= 2e-5, err


RANK = """
    import json, os, sys
    import torch
    import torch.distributed as dist
    rank, world, port = (int(a) for a in sys.argv[1:4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops, ref
    mesh = init_device_mesh("cpu", (world,))
    g = torch.Generator().manual_seed(0)
    B, S, H, P, C, k = 2, 6, 4, 8, 48, 4
    din = H * P
    plain = dict(
        xbc=torch.randn((B, S, C), generator=g), dt=torch.randn((B, S, H), generator=g),
        w=torch.randn((k, C), generator=g), b=torch.randn((C,), generator=g),
        dt_bias=torch.randn((H,), generator=g), A_log=torch.randn((H,), generator=g),
        y=torch.randn((B, S, H, P), generator=g), x=torch.randn((B, S, H, P), generator=g),
        D=torch.randn((H,), generator=g), z=torch.randn((B, S, din), generator=g),
        nw=torch.randn((din,), generator=g))
    # activations split over the batch; z and the norm weight over d_inner,
    # as the train launcher's "ff" rule places them; A_log split as FSDP
    # splits a parameter
    place = dict(xbc=[Shard(0)], dt=[Shard(0)], y=[Shard(0)], x=[Shard(0)],
                 z=[Shard(2)], nw=[Shard(0)], A_log=[Shard(0)])
    dts = {n: distribute_tensor(t, mesh, place.get(n, [Replicate()])
                                ).requires_grad_() for n, t in plain.items()}
    plain = {n: t.requires_grad_() for n, t in plain.items()}
    out = {}
    for name, names in [("conv", ("xbc", "dt", "w", "b", "dt_bias", "A_log")),
                        ("gate", ("y", "x", "D", "z", "nw"))]:
        extra = (1e-5, 1) if name == "gate" else ()
        got = getattr(ops, "mamba_" + name)(*[dts[n] for n in names], *extra)
        want = getattr(ref, "mamba_" + name + "_ref")(
            *[plain[n] for n in names], *extra)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        # the batch split is kept on the outputs that have a batch
        out[name + "_split"] = ["batch" if t.placements[0].is_shard(0) else
                                "whole" if t.placements[0].is_replicate()
                                else str(t.placements[0]) for t in got]
        full = [t.full_tensor() for t in got]
        out[name] = max(float((a - b).abs().max()) for a, b in zip(full, want))
        sum(t.pow(2).sum() for t in full).backward()
        sum(t.pow(2).sum() for t in want).backward()
        out[name + "_grads"] = max(
            float((dts[n].grad.full_tensor() - plain[n].grad).abs().max())
            / float(plain[n].grad.abs().max()) for n in names)
    if rank == 0:
        print(json.dumps(out))
    dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_dtensors_take_the_plain_version_and_carry_gradients(tmp_path):
    """On DTensors over two gloo ranks the entries run on the local shards
    of the batch (d_inner's split redistributed), where a CPU shard takes
    the plain version: the full outputs equal the plain version's on the
    full tensors, the batch split is kept, and every input's gradient
    equals the plain version's, A_log's (split like a parameter, its A
    whole on each shard) included."""
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent(RANK))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop(ops.MODE_ENV, None)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    assert res["conv_split"] == ["batch", "batch", "whole"]
    assert res["gate_split"] == ["batch"]
    # fp32 within rounding: a shard's elementwise loops may vectorise
    # otherwise than the whole tensor's, and sums run per shard
    assert res["conv"] < 1e-5 and res["conv_grads"] < 1e-5
    assert res["gate"] < 1e-5 and res["gate_grads"] < 1e-5


def test_cuda_mode_refuses_a_cpu_tensor():
    ops.set_kernel_mode("cuda")
    try:
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            ops.mamba_gate(*(torch.zeros(s) for s in
                             ((1, 2, 4), (1, 2, 4), (2,), (1, 8), (8,))),
                           1e-5)
    finally:
        ops.set_kernel_mode(None)


def test_served_families_call_each_entry_once_a_layer():
    """Each Mamba2 layer of a prefill calls ``mamba_conv`` and
    ``mamba_gate`` once, a decode step ``mamba_gate`` once a layer: the
    count the launch counters read on the card."""
    from repro_torch.models import transformer as tf
    for arch in ("mamba2-780m", "zamba2-2.7b", "zamba2-7b-instruct"):
        cfg = get_config(arch).reduced()
        params = ModelProgram(cfg).init(0, device="cpu", dtype=torch.float32)
        calls = {"mamba_conv": 0, "mamba_gate": 0}
        real = {n: getattr(ops, n) for n in calls}

        def counting(name):
            def fn(*a, **kw):
                calls[name] += 1
                return real[name](*a, **kw)
            return fn
        tokens = torch.randint(0, cfg.vocab_size, (1, 7),
                               generator=torch.Generator().manual_seed(0))
        try:
            for n in calls:
                setattr(ops, n, counting(n))
            with torch.no_grad():
                _, cache = tf.prefill(params, cfg, tokens)
                assert calls == {"mamba_conv": cfg.n_layers,
                                 "mamba_gate": cfg.n_layers}, arch
                tf.decode_step(params, cfg, cache, tokens[:, :1])
        finally:
            for n, fn in real.items():
                setattr(ops, n, fn)
        assert calls == {"mamba_conv": cfg.n_layers,
                         "mamba_gate": 2 * cfg.n_layers}, arch
