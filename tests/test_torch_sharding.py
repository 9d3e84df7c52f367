"""The port's mesh and sharding policy (``repro_torch.launch.mesh``,
``repro_torch.launch.sharding``) against the reference's
(``repro.launch.mesh``, ``repro.launch.sharding``), spec for spec, and
the port's analogues of the five checks of ``tests/test_sharding.py``.

Meshes that need more than one rank (the (4, 2) mesh of the multi-device
check, the production meshes) live on the ``fake`` process group, in a
subprocess: a process has one default group, and this one may hold the
world of one that ``make_local_mesh`` starts on the CPU.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import dryrun as jdryrun
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroof
from repro.launch import sharding as jsh
from repro.models import transformer as jtf
from repro.models.programs import ModelProgram as JProgram
from repro_torch.configs import SHAPES, applicable_shapes, get_config, list_archs
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troof
from repro_torch.launch import sharding as tsh
from repro_torch.models.programs import ModelProgram

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def jparams(arch: str):
    cfg = jget_config(arch)
    return jax.eval_shape(
        lambda: jtf.init_params(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def tparams(arch: str):
    return ModelProgram(get_config(arch)).init(0, device="meta")


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def jflat_specs(specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in leaves}


def norm(spec) -> tuple:
    """A spec with one-axis tuples as the axis (``PartitionSpec`` writes
    ``("data",)`` as ``"data"``; both name the same sharding)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def both_rules(mesh_name: str, **kw):
    shape, names = MESHES[mesh_name]
    jr = jsh.default_rules(jmesh.make_abstract_mesh(shape, names), **kw)
    tr = tsh.default_rules(tmesh.make_abstract_mesh(shape, names), **kw)
    return jr, tr


def assert_specs_equal(arch, jr, tr):
    want = jflat_specs(jsh.param_specs(jparams(arch), jr, jget_config(arch)))
    got = flat(tsh.param_specs(tparams(arch), tr, get_config(arch)))
    assert set(got) == set(want)
    for path in want:
        assert got[path] == want[path], (arch, path, got[path], want[path])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch, fsdp, mesh_name):
    """Every leaf's spec, every arch of the registry, both rule sets, the
    local and both production meshes (gemma3's one KV head, granite-moe's
    8, qwen's 2 and the 8 of the rest cover the kv-shardable cases)."""
    jr, tr = both_rules(mesh_name, fsdp=fsdp)
    assert_specs_equal(arch, jr, tr)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["dbrx-132b", "granite-moe-1b-a400m"])
def test_param_specs_match_reference_with_moe_ff(arch, mesh_name):
    """2D expert parallelism (``moe_ff`` set): F sharded in place of D."""
    jr, tr = both_rules(mesh_name, fsdp=True)
    jr = dataclasses.replace(jr, moe_ff="data")
    tr = dataclasses.replace(tr, moe_ff="data")
    assert_specs_equal(arch, jr, tr)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_spec_and_kv_seq_rules_match_reference(mesh_name):
    axes = [("batch", None, "ff"), ("batch", "kv_seq", "kv_heads", None),
            (None, "batch", None, "vocab"), ("heads",), ("fsdp", "experts")]
    for kw in (dict(), dict(fsdp=True), dict(kv_seq=True),
               dict(fsdp=True, kv_seq=True)):
        jr, tr = both_rules(mesh_name, **kw)
        for f in dataclasses.fields(jr):
            if f.name != "mesh":
                assert getattr(tr, f.name) == getattr(jr, f.name), (kw, f)
        for ax in axes:
            with jsh.use_rules(jr), tsh.use_rules(tr):
                assert norm(tsh.logical_spec(*ax)) == \
                    norm(jsh.logical_spec(*ax))
    assert tsh.logical_spec("batch") == ()         # no rules: replicated


def jplacements(mesh, sharding) -> tuple:
    return tsh.spec_placements(mesh, tuple(sharding.spec))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-2.7b",
                                  "internvl2-76b", "musicgen-large"])
def test_batch_and_cache_shardings_match_reference(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    jm = jmesh.make_abstract_mesh(shape, names)
    tm = tmesh.make_abstract_mesh(shape, names)
    jp, tp = JProgram(jget_config(arch)), ModelProgram(get_config(arch))
    for sname in ("train_4k", "prefill_32k", "decode_32k"):
        s = SHAPES[sname]
        for B in (s.global_batch, 1):
            s = dataclasses.replace(s, global_batch=B)
            want = jdryrun._batch_sharding(jm, jp.input_specs(s))
            got = tdryrun._batch_sharding(tm, tp.input_specs(s))
            assert set(got) == set(want)
            for k in want:
                assert got[k].placements == jplacements(tm, want[k]), k
    for kw in (dict(), dict(kv_seq=True)):
        jr, tr = both_rules(mesh_name, **kw)
        jr = dataclasses.replace(jr, kv_heads="model")
        tr = dataclasses.replace(tr, kv_heads="model")
        want = jdryrun._cache_sharding(jm, jp.cache_specs(128, 32768), jr)
        got = tdryrun._cache_sharding(tm, tp.cache_specs(128, 32768), tr)
        assert set(got) == set(want)
        for k in want:
            assert got[k].placements == jplacements(tm, want[k]), (k, kw)


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_n_micro_and_input_specs_match_reference(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jp, tp = JProgram(jcfg), ModelProgram(tcfg)
    for shape in applicable_shapes(tcfg):
        assert tdryrun.model_flops(tcfg, shape) == \
            jdryrun.model_flops(jcfg, shape)
        assert tdryrun.n_micro_for(tcfg, shape) == \
            jdryrun.n_micro_for(jcfg, shape)
        want = jp.input_specs(shape)
        got = tp.input_specs(shape)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape
            assert str(got[k].dtype).removeprefix("torch.") == \
                want[k].dtype.name


# ---- the port's analogues of tests/test_sharding.py ----------------------
def test_param_rules_no_duplicate_axes():
    """No spec may map one mesh axis to two dims (for every arch and both
    serve/train rule-sets)."""
    m = tmesh.make_abstract_mesh((1, 1), ("data", "model"))
    for arch in ("qwen2.5-3b", "dbrx-132b", "granite-moe-1b-a400m",
                 "mamba2-780m", "zamba2-2.7b", "gemma3-1b"):
        cfg = get_config(arch).reduced()
        params = ModelProgram(cfg).init(0, device="meta")
        for fsdp in (False, True):
            specs = tsh.param_specs(params, tsh.default_rules(m, fsdp=fsdp),
                                    cfg)
            for s in flat(specs).values():
                axes = [a for dim in s for a in
                        (dim if isinstance(dim, tuple) else (dim,))
                        if a is not None]
                assert len(axes) == len(set(axes)), (arch, s)


def test_kv_replicated_when_heads_not_divisible():
    """gemma3 has 1 KV head: its wk/wv must be replicated under TP-16
    (production mesh geometry on an abstract mesh, no devices)."""
    m = tmesh.make_abstract_mesh((16, 16), ("data", "model"))
    cfg = get_config("gemma3-1b")
    specs = tsh.param_specs(tparams("gemma3-1b"), tsh.default_rules(m), cfg)
    assert all(a is None for a in specs["layers"]["attn"]["wk"])
    assert "model" in [a for a in specs["layers"]["attn"]["wq"] if a]


def test_logical_spec_resolution():
    m = tmesh.make_abstract_mesh((1, 1), ("data", "model"))
    rules = tsh.default_rules(m, fsdp=True, kv_seq=True)
    with tsh.use_rules(rules):
        assert tsh.logical_spec("batch", None, "ff") == (None, None, "model")
        # kv_seq claims data; batch excludes it
        assert rules.kv_seq == "data"
        assert "data" not in rules.batch


def test_no_rules_is_noop():
    x = torch.ones((4, 4))
    assert tsh.shard(x, "batch", None) is x
    # rules on an abstract mesh, and a plain tensor: still x itself
    m = tmesh.make_abstract_mesh((16, 16), ("data", "model"))
    with tsh.use_rules(tsh.default_rules(m)):
        assert tsh.shard(x, "batch", None) is x


def run_child(code: str, timeout: int = 300) -> dict:
    """Run ``code`` in a fresh interpreter (its own default process
    group) with the port importable; its last stdout line is JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


MULTI = """
    import json, torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.roofline import StepCounter, analyze
    from repro_torch.launch.sharding import (default_rules,
                                             named_sharding_tree, on_mesh,
                                             place, use_rules)
    from repro_torch.launch.dryrun import _batch_sharding
    from repro_torch.models.programs import ModelProgram

    mesh = make_fake_mesh((4, 2), ("data", "model"))
    cfg = get_config("qwen2.5-3b").reduced()
    prog = ModelProgram(cfg, remat=False)
    rules = default_rules(mesh, fsdp=True)
    ops.set_kernel_mode("ref")
    with use_rules(rules):
        params = prog.init(0, device="meta")
        params = place(params, named_sharding_tree(params, rules, cfg))
        for t in [v for d in params["layers"].values() for v in
                  (d.values() if isinstance(d, dict) else [d])]:
            t.requires_grad_()
        tok = torch.empty((8, 32), dtype=torch.int32, device="meta")
        batch = {"tokens": tok, "labels": tok}
        batch = place(batch, _batch_sharding(mesh, batch))
        c = StepCounter()
        with c, on_mesh():
            loss, _ = prog.loss_fn(params, batch)
            loss.backward()
    ops.set_kernel_mode(None)
    r = analyze(c.counts, mesh.size())
    print(json.dumps({"flops": r.flops_per_device,
                      "wire": r.wire_bytes_per_device,
                      "ncoll": r.collectives["count"]}))
"""


def test_multi_device_fake_mesh_counts_collectives():
    """Reduced qwen grads on a (4, 2) mesh of the fake group with FSDP +
    TP: the counter must see flops, collectives and their wire bytes."""
    stats = run_child(MULTI)
    assert stats["flops"] > 0
    assert stats["ncoll"] > 0          # FSDP+TP must emit collectives
    assert stats["wire"] > 0


MATMUL = """
    import json, torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.roofline import StepCounter
    mesh = make_fake_mesh((4, 2), ("data", "model"))
    M, K, N = 1024, 512, 256
    a = distribute_tensor(torch.empty(M, K, device="meta"), mesh,
                          [Shard(0), Replicate()])
    b = distribute_tensor(torch.empty(K, N, device="meta"), mesh,
                          [Replicate(), Shard(1)])
    c = StepCounter()
    with c:
        out = a @ b
    print(json.dumps({"flops": c.counts.flops, "global": 2.0 * M * K * N,
                      "ncoll": c.counts.collectives["count"],
                      "local": list(out.to_local().shape)}))
"""


def test_per_device_flops_of_a_divisible_matmul_are_global_over_8():
    """A (1024 x 512) @ (512 x 256) product, rows over data (4), columns
    over model (2): this rank multiplies (256 x 512) @ (512 x 128), an
    eighth of the product, with no collective."""
    r = run_child(MATMUL)
    assert r["local"] == [256, 128]
    assert r["ncoll"] == 0
    assert r["flops"] == r["global"] / 8


def hlo_line(kind: str, g: int) -> str:
    """One collective of ``kind`` writing f32[1024] over groups of ``g``
    (the iota form, the list form for all-reduce; a permute has pairs)."""
    groups = f"replica_groups=[{32 // g},{g}]<=[32]"
    if kind == "all-reduce":
        groups = "replica_groups={{" + ",".join(map(str, range(g))) + "}}"
    elif kind == "collective-permute":
        groups = "source_target_pairs={{0,1}}"
    return f"%x = f32[1024]{{0}} {kind}(f32[1024]{{0}} %p), {groups}"


@pytest.mark.parametrize("g", [2, 4, 8, 16])
@pytest.mark.parametrize("kind", list(troof.KINDS))
def test_wire_bytes_match_reference_ring_formulas(kind, g):
    want = jroof.collective_bytes(hlo_line(kind, g))
    assert want["count"] == 1
    assert troof.wire_bytes(kind, 1024 * 4, g) == want[kind]


def test_train_launcher_takes_the_reference_meshes(capsys):
    """``--data-model 1,1`` trains on the CPU mesh and prints it; ``2,1``
    clamps to (1, 1) as the reference's ``make_local_mesh`` does; ``1,2``
    (more model ranks than the world has) raises."""
    from repro_torch.launch import train
    common = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
              "16"]
    losses = train.main(common + ["--data-model", "1,1"])
    out = capsys.readouterr().out
    assert "DeviceMesh((data=1, model=1)" in out
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert train.main(common + ["--data-model", "2,1"]) == losses
    assert "DeviceMesh((data=1, model=1)" in capsys.readouterr().out
    assert tuple(tmesh.make_local_mesh(2, 1, device_type="cpu").shape) == \
        (1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        train.main(common + ["--data-model", "1,2"])


@pytest.mark.parametrize("arch", list_archs())
def test_train_launcher_trains_every_family_on_the_cpu_mesh(arch):
    """Every family's reduced config trains 2 steps through the launcher
    on the (1, 1) mesh, on plain tensors (a mesh of one splits nothing);
    then the trained leaves, placed on the FSDP shardings the launcher
    resolved, take a step on DTensors (the vlm prefix, the audio frames,
    the moe routing and the ssm scan); the only ops resharded are views
    that merge a dim split over a mesh axis (of size 1 here)."""
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves
    args = train.parse_args(["--device", "cpu", "--arch", arch, "--steps",
                             "2", "--batch", "2", "--seq", "16"])
    run = train.run(args)
    assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()
    assert not run["placed"] and run["reshards"] == {}
    mesh, rules, pshard = run["mesh"], run["rules"], run["pshard"]
    params = tsh.place(run["params"], pshard)
    opt_state = dict(run["opt_state"], m=tsh.place(run["opt_state"]["m"],
                                                   pshard),
                     v=tsh.place(run["opt_state"]["v"], pshard))
    cfg = get_config(arch).reduced()
    batch = train.make_batch(cfg, args, 2, {
        "tokens": np.ones((2, 16), np.int32),
        "labels": np.ones((2, 16), np.int32)}, torch.device("cpu"))
    batch = tsh.place(batch, tsh.batch_sharding(mesh, batch))
    with tsh.use_rules(rules), tsh.on_mesh() as fallback:
        mets = run["step_fn"](params, opt_state, batch)[2]
    assert np.isfinite(float(mets["loss"]))
    assert set(fallback.reshards) <= {"aten.view.default"}
    for t, sh in zip(tree_leaves(params), tree_leaves(pshard)):
        assert tuple(t.placements) == tuple(sh.placements)


RANK = """
    import json, sys
    import torch.distributed as dist
    rank, world, port, dm, arch = sys.argv[1:6]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=int(rank), world_size=int(world))
    from repro_torch.launch import train
    run = train.run(train.parse_args([
        "--device", "cpu", "--arch", arch, "--steps", "2", "--batch", "2",
        "--seq", "16", "--data-model", dm]))
    print(json.dumps({"losses": run["losses"], "placed": run["placed"],
                      "reshards": run["reshards"],
                      "mesh": list(run["mesh"].shape)}))
    dist.destroy_process_group()
"""


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("dm,arch", [
    ("2,1", "qwen2.5-3b"), ("2,2", "qwen2.5-3b"),
    ("2,2", "granite-moe-1b-a400m"), ("2,2", "zamba2-2.7b")])
def test_train_launcher_on_gloo_ranks_matches_one_device(dm, arch):
    """The launcher in 2 or 4 processes of one gloo group (``--data-model
    2,1`` / ``2,2``: params and batch on DTensors, real collectives)
    gives every rank the losses of the one-device run within 2e-3
    (reduced configs compute in bf16; the sums split over ranks), prints
    its resharded ops after the first step, and reshards none."""
    from repro_torch.launch import train
    want = train.main(["--device", "cpu", "--arch", arch, "--steps", "2",
                       "--batch", "2", "--seq", "16"])
    world = int(np.prod([int(x) for x in dm.split(",")]))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK), str(r), str(world),
         str(port), dm, arch], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "[train] ops resharded in the first step: {}" in out
        got = json.loads(out.strip().splitlines()[-1])
        assert got["placed"] and got["reshards"] == {}
        assert got["mesh"] == [int(x) for x in dm.split(",")]
        np.testing.assert_allclose(got["losses"], want, rtol=2e-3)


def test_async_checkpoint_of_placed_leaves_is_a_snapshot(tmp_path,
                                                         monkeypatch):
    """``save_async`` of a tree placed on the (1, 1) CPU mesh, whose leaves
    the step then updates in place before the writer runs: the checkpoint
    holds the values of the step it was taken at."""
    import threading

    from repro_torch.ft import checkpoint as ckpt
    mesh = tmesh.make_local_mesh(1, 1, device_type="cpu")
    tree = {"w": torch.arange(8.0).reshape(2, 4), "b": torch.ones(4)}
    shardings = {"w": tsh.NamedSharding(mesh, tsh.spec_placements(
                     mesh, (None, "data"))),
                 "b": tsh.NamedSharding(mesh, tsh.spec_placements(mesh, ()))}
    placed = tsh.place(tree, shardings)
    want = {k: v.full_tensor().clone() for k, v in placed.items()}
    updated = threading.Event()
    save = ckpt.save

    def late_save(*a, **kw):
        updated.wait(timeout=30)
        return save(*a, **kw)
    monkeypatch.setattr(ckpt, "save", late_save)
    writer = ckpt.AsyncCheckpointer(str(tmp_path))
    writer.save_async(0, placed)
    for v in placed.values():
        v.add_(100.0)                          # the next step, in place
    updated.set()
    writer.wait()
    meta = {k: torch.empty(v.shape, device="meta") for k, v in tree.items()}
    back = ckpt.restore(str(tmp_path), 0, meta)
    for k in tree:
        assert torch.equal(back[k], want[k]), k


def test_train_launcher_micro_batches_compression_and_remat_on_the_mesh():
    """n_micro 2 (one-row micro-batches of a batch split over ``data``),
    error-feedback compression and full remat on placed leaves."""
    from repro_torch.launch import train
    losses = train.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--n-micro", "2", "--compress",
                         "--remat"])
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_local_mesh_without_a_gpu_raises_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default mesh is the card's")
    with pytest.raises(RuntimeError, match="no GPU"):
        tmesh.make_local_mesh(1, 1)


def test_elastic_remesh_and_restore_round_trip_the_reference_init(tmp_path):
    """Reduced qwen's reference init, made torch by ``params_from_numpy``,
    placed on the FSDP shardings of the CPU mesh; a checkpoint of it
    restores onto the same shardings, and ``elastic_remesh`` of its host
    arrays places them back, bit-equal, on the same placements."""
    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.ft.failures import elastic_remesh
    from repro_torch.models.convert import params_from_numpy
    jcfg = jget_config("qwen2.5-3b").reduced()
    cfg = get_config("qwen2.5-3b").reduced()
    host = jax.tree.map(np.asarray,
                        JProgram(jcfg).init(jax.random.PRNGKey(0)))
    params = params_from_numpy(host, device="cpu")
    mesh = tmesh.make_local_mesh(1, 1, device_type="cpu")
    rules = tsh.default_rules(mesh, fsdp=True)
    shardings = tsh.named_sharding_tree(params, rules, cfg)
    placed = elastic_remesh(params, shardings)
    ckpt.save(str(tmp_path), 3, placed)
    meta = jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), params)
    back = ckpt.restore(str(tmp_path), 3, meta, shardings=shardings)
    again = elastic_remesh(host, shardings)
    for path, want in flat(params).items():
        for tree in (placed, back, again):
            got = flat(tree)[path]
            assert tuple(got.placements) == \
                flat(shardings)[path].placements
            assert torch.equal(got.full_tensor(), want), path
