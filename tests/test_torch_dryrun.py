"""The port's dry-run and roofline (``repro_torch.launch.dryrun``,
``launch/roofline``, ``launch/roofline_table``, ``launch/hillclimb``),
the kernels' DTensor route (``kernels/ops``), the ``remat="dots"``
policy, and the train step on placed leaves.

A dry-run starts the ``fake`` process group, so it runs in a subprocess
(with a ``timeout``); the in-process checks use the world of one that
``make_local_mesh`` starts on the CPU.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref, rmsnorm_ref
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch.roofline import StepCounter, analyze
from repro_torch.models.programs import ModelProgram, cross_entropy

ROOT = Path(__file__).resolve().parents[1]


def run_child(code: str, cwd=ROOT, args=(), timeout: int = 300) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          *map(str, args)], capture_output=True, text=True,
                         env=env, cwd=str(cwd), timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cli_writes_a_record_that_roofline_table_renders(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape
    train_4k`` on the CPU: a record of the flagship cell on the 16x16
    fake mesh whose terms ``roofline_table`` renders."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-3b", "--shape", "train_4k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ALL DRY-RUN CELLS PASSED" in out.stdout
    rec = json.loads((tmp_path / "16x16__qwen2.5-3b__train_4k.json")
                     .read_text())
    r = rec["roofline"]
    assert rec["n_devices"] == 256 and rec["kernel_route"] == "plain"
    assert rec["n_micro"] == 4
    assert r["flops_per_device"] > 0 and r["wire_bytes_per_device"] > 0
    assert r["n_collectives"] > 0
    assert r["raw_bytes_per_device"] == r["bytes_per_device"]
    assert r["cpu_artifact_ops_corrected"] == 0
    assert 0 < rec["useful_flops_frac"] <= 1
    from repro_torch.launch import roofline_table
    rows = roofline_table.main(["--dir", str(tmp_path)])
    table = capsys.readouterr().out
    assert len(rows) == 1
    assert f"{r['t_compute_s']:.4f}s | {r['t_memory_s']:.4f}s" in table
    assert f"{r['t_collective_s']:.4f}s" in table


CELLS = """
    import json, sys
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import run_cell
    ops.set_kernel_mode("cuda")
    one = ((1, 1), ("data", "model"))
    out = {}
    for arch, shape, mesh in (("mamba2-780m", "prefill_32k", None),
                              ("zamba2-2.7b", "long_500k", None),
                              ("gemma3-1b", "decode_32k", None),
                              ("granite-moe-1b-a400m", "decode_32k", None),
                              ("mamba2-780m", "decode_32k", one)):
        rec = run_cell(arch, shape, mesh_axes=mesh, out_dir=sys.argv[1],
                       verbose=False)
        out[f"{arch} {shape} {rec['mesh']}"] = {
            "route": rec["kernel_route"], "mode": ops._mode_override,
            "flops": rec["roofline"]["flops_per_device"],
            "bytes": rec["roofline"]["bytes_per_device"],
            "ncoll": rec["roofline"]["n_collectives"],
            "fit": rec["hbm_fit_bytes"]}
    print(json.dumps(out))
"""


def test_serve_cells_of_every_family_count_and_restore_the_mode(tmp_path):
    """Prefill and decode cells of the ssm, hybrid, dense and moe
    families count flops and bytes on the production mesh (collectives
    where the layout needs them, none on one device); the dry-run runs
    the plain versions and leaves the kernel mode as it found it."""
    out = run_child(CELLS, args=(tmp_path,))
    assert len(list(tmp_path.glob("*.json"))) == 5
    for cell, r in out.items():
        assert r["route"] == "plain" and r["mode"] == "cuda", cell
        assert r["flops"] > 0 and r["bytes"] > 0 and r["fit"] > 0, cell
    assert out["gemma3-1b decode_32k 16x16"]["ncoll"] > 0
    assert out["mamba2-780m decode_32k 1x1"]["ncoll"] == 0


def test_hillclimb_variant_writes_its_tagged_record(tmp_path):
    """H4 of the qwen cell: pure FSDP over 256 ranks, bf16 casts and
    gradients, the matmul outputs saved; its record lands in the port's
    own ``experiments/hillclimb_torch/``, tagged."""
    out = run_child("""
        import json
        from repro_torch.launch import hillclimb
        rec = hillclimb.main(["--cell", "qwen_train", "--it", "4"])
        print(json.dumps({"tag": rec["tag"], "n_micro": rec["n_micro"],
                          "roof": rec["roofline"]}))
    """, cwd=tmp_path)
    assert out["tag"] == "hc4_fsdp256_dots" and out["n_micro"] == 1
    assert out["roof"]["wire_bytes_per_device"] > 0
    assert (tmp_path / "experiments" / "hillclimb_torch" /
            "16x16__qwen2.5-3b__train_4k__hc4_fsdp256_dots.json").exists()


FLASH = """
    import json, torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_fake_mesh
    mesh = make_fake_mesh((4, 2), ("data", "model"))
    ops.set_kernel_mode("ref")          # meta tensors: the plain versions
    q = distribute_tensor(torch.empty(8, 16, 4, 16, device="meta"), mesh,
                          [Shard(0), Shard(2)])
    kv = distribute_tensor(torch.empty(8, 16, 1, 16, device="meta"), mesh,
                           [Shard(0), Replicate()])
    x = distribute_tensor(torch.empty(8, 16, 64, device="meta"), mesh,
                          [Shard(0), Shard(2)])
    w = distribute_tensor(torch.empty(64, device="meta"), mesh,
                          [Replicate(), Replicate()])
    o = ops.flash_attention(q, kv, kv)
    n = ops.rmsnorm(x, w)
    print(json.dumps({"attn": [str(p) for p in o.placements],
                      "attn_local": list(o.to_local().shape),
                      "norm": [str(p) for p in n.placements],
                      "norm_local": list(n.to_local().shape)}))
"""


def test_kernel_entry_points_run_dtensors_on_exact_shards():
    """On a (4, 2) mesh: attention keeps q's batch and head splits (its
    one KV head is repeated to q's heads, so each shard has whole
    groups); rmsnorm keeps the row split and replicates the normalized
    dim first."""
    out = run_child(FLASH)
    assert out["attn"] == ["S(0)", "S(2)"]
    assert out["attn_local"] == [2, 16, 2, 16]
    assert out["norm"] == ["S(0)", "R"]
    assert out["norm_local"] == [2, 16, 64]


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_local_mesh(1, 1, device_type="cpu")


def test_kernel_route_and_label_gather_on_dtensors_match_plain(mesh):
    """On the CPU's (1, 1) mesh the DTensor route of rmsnorm and flash
    attention (the plain versions on the local shards) and the
    cross-entropy's sharded label gather equal the plain tensors'."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 32, generator=g)
    w = torch.randn(32, generator=g)
    q = torch.randn(2, 8, 4, 16, generator=g)
    k = torch.randn(2, 8, 2, 16, generator=g)
    v = torch.randn(2, 8, 2, 16, generator=g)
    d = lambda t, *pl: distribute_tensor(t, mesh, list(pl))
    got = ops.rmsnorm(d(x, Shard(0), Shard(2)), d(w, Replicate(),
                                                  Replicate()))
    assert torch.equal(got.full_tensor(), rmsnorm_ref(x, w))
    got = ops.flash_attention(d(q, Shard(0), Shard(2)),
                              d(k, Shard(0), Shard(2)),
                              d(v, Shard(0), Shard(2)), window=3)
    assert torch.equal(got.full_tensor(),
                       flash_attention_ref(q, k, v, window=3))
    logits = torch.randn(2, 8, 50, generator=g)
    labels = torch.randint(0, 50, (2, 8), generator=g)
    labels[0, 0] = -1
    got = cross_entropy(d(logits, Shard(0), Shard(2)),
                        d(labels, Shard(0), Replicate()))
    assert torch.allclose(got.full_tensor(), cross_entropy(logits, labels),
                          rtol=1e-6, atol=0)


def test_train_step_on_placed_leaves_matches_plain_leaves(mesh):
    """Reduced qwen, fp32: two train steps (n_micro 2, so the gradient
    accumulation and the micro-batch split run) on params placed on the
    FSDP shardings of the (1, 1) mesh give the losses and grad norms of
    two steps on plain tensors, and after the first step the same params
    within 1% of an update (lr 1e-3; DTensor's products may sum in
    another order, and AdamW's m / sqrt(v) magnifies fp32 noise where a
    gradient is near 0)."""
    import dataclasses

    from repro_torch.launch.dryrun import _batch_sharding
    from repro_torch.optim import AdamW, constant
    from repro_torch.optim.adamw import tree_leaves
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              dtype="float32")
    prog = ModelProgram(cfg, remat=False)
    opt = AdamW(lr=constant(1e-3))
    rules = tsh.default_rules(mesh, fsdp=True)
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                        dtype=torch.int32)
    batch = {"tokens": tok, "labels": tok}
    runs = {}
    for placed in (False, True):
        params = prog.init(0, device="cpu")
        b = batch
        with tsh.use_rules(rules), tsh.on_mesh():
            if placed:
                params = tsh.place(params, tsh.named_sharding_tree(
                    params, rules, cfg))
                b = tsh.place(batch, _batch_sharding(mesh, batch))
            state = opt.init(params)
            step = prog.make_train_step(opt, n_micro=2)
            mets = [step(params, state, b)[2]]
            first = [(t.full_tensor() if placed else t).clone()
                     for t in tree_leaves(params)]
            mets.append(step(params, state, b)[2])
        runs[placed] = ([float(m["loss"]) for m in mets],
                        [float(m["grad_norm"]) for m in mets], first)
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-6)
    np.testing.assert_allclose(runs[True][1], runs[False][1], rtol=1e-6)
    for a, b in zip(runs[True][2], runs[False][2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_remat_dots_saves_the_matmuls_and_keeps_the_gradients():
    """``remat="dots"`` recomputes no product in the backward (the flops
    of no remat; full remat recomputes the forward's), and every
    variant's gradients are those of no remat."""
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              dtype="float32")
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    flops, grads = {}, {}
    for remat in (False, True, "dots"):
        prog = ModelProgram(cfg, remat=remat)
        params = prog.init(0, device="cpu")
        w = params["layers"]["mlp"]["w_up"].requires_grad_()
        c = StepCounter()
        with c:
            loss, _ = prog.loss_fn(params, {"tokens": tok, "labels": tok})
            loss.backward()
        flops[remat], grads[remat] = c.counts.flops, w.grad
    assert flops["dots"] == flops[False] < flops[True]
    assert torch.equal(grads["dots"], grads[False])
    assert torch.equal(grads[True], grads[False])


def test_step_counter_counts_flops_bytes_and_live_bytes():
    """A plain (64 x 32) @ (32 x 16) product: 2 M K N flops and its
    operands read and result written once; a view moves nothing; a
    zero_ writes its tensor without reading it; an in-place add reads
    both; the peak of live bytes holds the product's result."""
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    c = StepCounter()
    with c:
        out = a @ b
        out.view(16, 64)
        out.zero_()
        out.add_(out)
    want = (64 * 32 + 32 * 16 + 64 * 16) * 4 + 64 * 16 * 4 + 3 * 64 * 16 * 4
    assert c.counts.flops == 2 * 64 * 32 * 16
    assert c.counts.bytes == want
    assert c.counts.peak_live_bytes == 64 * 16 * 4
    r = analyze(c.counts, 1, scale=2.0)
    assert r.flops_per_device == 2 * c.counts.flops
    assert r.bottleneck == "memory" and r.t_collective == 0


def test_reshard_fallback_runs_a_view_dtensor_refuses(mesh):
    """A view that merges a sharded dim of one row: DTensor refuses it;
    under ``on_mesh`` the fallback replicates that dim first and the
    view gives the plain tensor's values, the reshard counted."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    want = torch.arange(16.0).reshape(1, 4, 4)
    x = distribute_tensor(want, mesh, [Shard(0), Replicate()])
    with pytest.raises(RuntimeError, match="harding"):
        x.view(4, 4)
    with tsh.on_mesh() as fallback:
        y = x.view(4, 4)
    assert torch.equal(y.full_tensor(), want.view(4, 4))
    assert dict(fallback.reshards) == {"aten.view.default": 1}
