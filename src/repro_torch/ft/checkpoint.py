"""Atomic, async checkpointing of trees of tensors.

Layout:  <dir>/step_<N>/
           manifest.json        tree structure, shapes, dtypes, step
           <flat-key>.npy       one file per leaf
         <dir>/step_<N>.done    commit marker (atomic rename)

The layout, the keys and the dtype names are those of
``repro.ft.checkpoint``, so a checkpoint written by either package
restores in the other: a leaf's key is its path of dict keys (or
list/tuple indices) joined by ``/``, and a bf16 or fp8 leaf, which
``.npy`` cannot name, is stored as a 16- or 8-bit unsigned integer view
with its logical dtype in the manifest. The views need no ``ml_dtypes``.

``restore`` places every leaf onto its sharding (a tree of
``launch/sharding.NamedSharding``: a mesh and its placements, as the
reference re-shards onto the current mesh) or on the device the caller
names; a template of meta tensors (``torch.empty(shape, dtype=...,
device="meta")``) gives the tree's structure and shapes without holding
any memory. A DTensor leaf is saved whole (``full_tensor``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.device import is_dtensor

# logical dtype -> the unsigned integer type its bytes are stored as, and
# the integer type of the same width that numpy and torch both name, to
# carry the bytes between them
_EXOTIC = {"bfloat16": (np.uint16, torch.int16),
           "float8_e4m3fn": (np.uint8, torch.uint8),
           "float8_e5m2": (np.uint8, torch.uint8)}
_NP = {torch.int16: np.int16, torch.uint8: np.uint8}


def _flatten(tree, prefix: tuple = (), keep: tuple = ()) -> dict:
    """{"/"-joined key path: leaf}; dict keys and sequence indices as
    ``jax.tree_util.tree_flatten_with_path`` names them, None leaves
    dropped (an empty subtree, as in jax). Instances of ``keep`` (e.g. a
    sharding, which is a tuple) are leaves."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),), keep))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, keep):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),), keep))
        return out
    return {} if tree is None else {"/".join(prefix): tree}


def _unflatten(template, leaves: dict, prefix: tuple = ()):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, prefix + (str(i),))
                              for i, v in enumerate(template))
    return None if template is None else leaves["/".join(prefix)]


def dtype_name(dtype) -> str:
    """numpy's name for a torch or numpy dtype ("bfloat16", "float32")."""
    return (str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype)
            else np.dtype(dtype).name)


def _to_numpy(leaf) -> np.ndarray:
    """A host array of the leaf's bytes: an exotic dtype as its unsigned
    integer view, anything else as itself."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        store = _EXOTIC.get(arr.dtype.name)
        return arr.view(store[0]) if store else arr
    t = leaf.detach()
    if is_dtensor(t):
        t = t.full_tensor()
    store = _EXOTIC.get(dtype_name(t.dtype))
    if store is not None:
        return t.view(store[1]).cpu().numpy().view(store[0])
    return t.cpu().numpy()


def save(ckpt_dir: str, step: int, tree, *, block: bool = True) -> str:
    """Atomic checkpoint write; returns the commit path."""
    flat = _flatten(tree)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}_{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "keys": {}}
    for key, leaf in flat.items():
        logical = dtype_name(leaf.dtype)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), _to_numpy(leaf))
        manifest["keys"][key] = {"file": fname, "shape": list(leaf.shape),
                                 "dtype": logical}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic commit
    with open(final + ".done", "w") as f:
        f.write(str(time.time()))
    return final


class AsyncCheckpointer:
    """Fire-and-forget saves on a writer thread (training never blocks on
    I/O); ``wait()`` joins outstanding writes before shutdown."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._pending: list = []

    def save_async(self, step: int, tree):
        # snapshot to host memory synchronously (cheap), write async
        host_tree = _unflatten(tree, {k: _host_copy(v)
                                      for k, v in _flatten(tree).items()})
        t = threading.Thread(target=self._write, args=(step, host_tree),
                             daemon=True)
        t.start()
        self._pending.append(t)

    def _write(self, step, host_tree):
        save(self.ckpt_dir, step, host_tree)
        self._gc()

    def _gc(self):
        steps = sorted(list_steps(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.ckpt_dir, f"step_{s}.done"))
            except OSError:
                pass

    def wait(self):
        for t in self._pending:
            t.join(timeout=30.0)
        self._pending.clear()


def _host_copy(leaf):
    """A host copy of ``leaf`` that the step's in-place updates cannot
    reach: on a mesh of one CPU rank ``full_tensor`` returns the live
    local tensor itself, so it is copied like a plain one."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        return leaf.to("cpu", copy=True)
    return np.array(leaf, copy=True)


def list_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name.endswith(".done"):
            out.append(int(name[len("step_"):-len(".done")]))
    return sorted(out)


def latest_step(ckpt_dir: str):
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, template, *, shardings=None,
            device=None):
    """Restore into the structure of ``template`` (a tree whose leaves
    carry ``.shape``, e.g. meta tensors), every leaf placed onto its
    entry of ``shardings`` (elastic restore onto the current mesh) or,
    without one, on ``device`` (the host when None)."""
    from repro_torch.launch.sharding import place
    final = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    flat_s = _flatten(shardings, keep=tuple) if shardings is not None \
        else {}
    leaves = {}
    for key, tmpl in _flatten(template).items():
        meta = manifest["keys"][key]
        arr = np.load(os.path.join(final, meta["file"]))
        store = _EXOTIC.get(meta["dtype"])
        if store is not None:
            t = torch.from_numpy(arr.view(_NP[store[1]])).view(
                getattr(torch, meta["dtype"]))
        else:
            t = torch.from_numpy(arr)
        want = tuple(getattr(tmpl, "shape", t.shape))
        if tuple(t.shape) != want:
            raise ValueError(f"checkpoint leaf {key}: shape {tuple(t.shape)}"
                             f", template wants {want}")
        sh = flat_s.get(key)
        leaves[key] = (place(t, sh) if sh is not None
                       else t if device is None else t.to(device))
    return _unflatten(template, leaves)
