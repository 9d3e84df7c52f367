"""repro_torch.ft.checkpoint against repro.ft.checkpoint: the same on-disk
layout, keys and dtype names, so a snapshot written by either package
restores bit-exactly in the other (bf16 leaves as uint16 views, no
ml_dtypes on the port's side); reduced qwen2.5-3b weights snapshotted by
the reference and restored by the port give the reference's logits at
the fp32 tolerance, 2e-5. All on the CPU."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.ft import checkpoint as jckpt
from repro.models.programs import ModelProgram as JProgram
from repro_torch.configs import get_config
from repro_torch.core.platform import meta_tree
from repro_torch.ft import checkpoint as ckpt
from repro_torch.models.programs import ModelProgram

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int32": torch.int32}


def port_tree(dtype: str, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    dt = TORCH_DTYPES[dtype]

    def leaf(*shape):
        if dt == torch.int32:
            return torch.randint(-1000, 1000, shape, generator=g,
                                 dtype=torch.int32)
        return torch.randn(shape, generator=g).to(dt)
    return {"embed": {"tok": leaf(7, 4)},
            "layers": {"w": leaf(3, 4, 5), "b": leaf(3, 5)},
            "head": [leaf(4), leaf(2, 2)],
            "scalar": leaf()}


def bits(x) -> np.ndarray:
    """The leaf's bytes as an integer array, for bit-exact comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return np.atleast_1d(x.view(torch.int16).numpy())
        x = x.numpy()
    x = np.atleast_1d(np.asarray(x))
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x.view(
        np.uint8)


def same_leaves(a: dict, b: dict) -> None:
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert tuple(fa[k].shape) == tuple(fb[k].shape), k
        assert np.array_equal(bits(fa[k]), bits(fb[k])), k


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_port_round_trip_is_bit_exact(tmp_path, dtype):
    tree = port_tree(dtype)
    path = ckpt.save(str(tmp_path), 3, tree)
    assert path == str(tmp_path / "step_3")
    assert (tmp_path / "step_3.done").exists()
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp")]
    back = ckpt.restore(str(tmp_path), 3, meta_tree(tree), device="cpu")
    same_leaves(back, tree)
    assert isinstance(back["head"], list)
    assert all(t.device.type == "cpu" and t.dtype == TORCH_DTYPES[dtype]
               for t in ckpt._flatten(back).values())
    with open(tmp_path / "step_3" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["keys"]["layers/w"] == {
        "file": "layers__w.npy", "shape": [3, 4, 5], "dtype": dtype}


def test_restore_rejects_a_shape_mismatch(tmp_path):
    tree = port_tree("float32")
    ckpt.save(str(tmp_path), 0, tree)
    bad = meta_tree(tree)
    bad["layers"]["w"] = torch.empty((3, 4, 6), device="meta")
    with pytest.raises(ValueError, match="layers/w"):
        ckpt.restore(str(tmp_path), 0, bad, device="cpu")


def to_jax(tree):
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_reference_snapshot_restores_in_port(tmp_path, dtype):
    tree = port_tree(dtype, seed=1)
    jckpt.save(str(tmp_path), 0, to_jax(tree))
    back = ckpt.restore(str(tmp_path), 0, meta_tree(tree), device="cpu")
    same_leaves(back, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_port_snapshot_restores_in_reference(tmp_path, dtype):
    tree = port_tree(dtype, seed=2)
    ckpt.save(str(tmp_path / "port"), 0, tree)
    jckpt.save(str(tmp_path / "ref"), 0, to_jax(tree))
    manifests = [json.loads((tmp_path / side / "step_0" /
                             "manifest.json").read_text())
                 for side in ("port", "ref")]
    assert manifests[0] == manifests[1]          # same keys, files, dtypes
    template = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            to_jax(tree))
    back = jckpt.restore(str(tmp_path / "port"), 0, template)
    assert str(back["layers"]["w"].dtype) == dtype
    same_leaves(jax.tree.map(np.asarray, back), tree)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m", "zamba2-2.7b"])
def test_checkpoint_keys_match_reference_for_served_families(arch):
    """The port's params tree flattens to the reference's keys and shapes
    (qwen2.5-3b 15 leaves, mamba2-780m 11, zamba2-2.7b 21)."""
    jp = JProgram(jget_config(arch).reduced()).init(jax.random.PRNGKey(0))
    tp = ModelProgram(get_config(arch).reduced()).init(0, device="cpu")
    jflat, _ = jckpt._flatten(jp)
    tflat = ckpt._flatten(tp)
    assert sorted(jflat) == list(tflat)
    assert {k: tuple(v.shape) for k, v in jflat.items()} == \
        {k: tuple(v.shape) for k, v in tflat.items()}
    assert len(tflat) == {"qwen2.5-3b": 15, "mamba2-780m": 11,
                          "zamba2-2.7b": 21}[arch]


def test_reference_snapshot_of_qwen_serves_reference_logits(tmp_path):
    arch = "qwen2.5-3b"
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jparams = JProgram(jcfg).init(jax.random.PRNGKey(0))
    jckpt.save(str(tmp_path), 0, {"params": jparams})
    template = {"params": meta_tree(ModelProgram(tcfg).init(1, device="cpu"))}
    tparams = ckpt.restore(str(tmp_path), 0, template, device="cpu")["params"]
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 12))
    toks = toks.astype(np.int32)
    jl, _ = JProgram(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, _ = ModelProgram(tcfg).prefill(tparams,
                                           {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=2e-5)


def test_async_checkpointer_keeps_the_newest_steps(tmp_path):
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    trees = {s: port_tree("float32", seed=s) for s in range(4)}
    for s, tree in trees.items():
        ac.save_async(s, tree)
        ac.wait()                    # in order, so the gc sees every step
    assert ckpt.list_steps(str(tmp_path)) == [2, 3]
    assert ckpt.latest_step(str(tmp_path)) == 3
    back = ckpt.restore(str(tmp_path), 3, meta_tree(trees[3]), device="cpu")
    same_leaves(back, trees[3])
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
