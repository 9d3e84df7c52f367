"""Logical-axis sharding policy (MaxText-style rules): a port of
``repro/launch/sharding.py`` onto ``DeviceMesh`` and DTensor placements.

Models annotate activations with ``shard(x, "batch", "seq", None)`` using
*logical* axis names; a thread-local ``AxisRules`` maps logical names to
mesh axes. Parameter specs are derived from tree paths by
``param_specs``.

Mesh axes: ``("pod", "data", "model")`` multi-pod, ``("data", "model")``
single pod. Logical axes:

  batch    -> (pod, data)            DP
  kv_seq   -> data (long-context SP) or None
  heads/ff/vocab/experts -> model    TP / EP
  fsdp     -> data (param+optimizer sharding for training / big-model serve)

A spec (the reference's ``PartitionSpec``) is a tuple with one entry per
tensor dim: a mesh axis name, a tuple of them, or None. A ``NamedSharding``
is ``(mesh, placements)``: one ``Shard(dim)`` or ``Replicate()`` per mesh
dim, so a spec that puts two mesh axes on one dim (``batch -> ("pod",
"data")``) shards that dim over both, pod-major as in JAX.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only

from repro_torch.launch.mesh import axis_names, mesh_shape


@dataclasses.dataclass(frozen=True)
class AxisRules:
    mesh: object = None               # DeviceMesh or AbstractMesh
    batch: tuple = ("data",)          # ("pod","data") on multi-pod meshes
    seq: Optional[str] = None         # activation seq sharding (rare)
    kv_seq: object = None             # KV-cache seq sharding (axis or tuple)
    kv_heads: Optional[str] = None    # KV-cache head sharding (GQA-divisible)
    heads: Optional[str] = "model"
    ff: Optional[str] = "model"
    vocab: Optional[str] = "model"
    experts: Optional[str] = "model"
    fsdp: Optional[str] = None        # extra param-shard axis ("data")
    moe_ff: Optional[str] = None      # 2D EP: expert FFN dim axis (e.g. "data")

    def resolve(self, name):
        if name is None:
            return None
        return getattr(self, name)


_tls = threading.local()


def current_rules() -> Optional[AxisRules]:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: AxisRules):
    prev = current_rules()
    _tls.rules = rules
    try:
        yield rules
    finally:
        _tls.rules = prev


def default_rules(mesh, *, fsdp: bool = False,
                  kv_seq: bool = False) -> AxisRules:
    axes = axis_names(mesh)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    if kv_seq:
        # sequence parallelism claims the data axis; batch keeps only pod
        # (long-context cells have global_batch=1 anyway)
        batch = tuple(a for a in batch if a != "data")
    return AxisRules(
        mesh=mesh,
        batch=batch or (None,),
        kv_seq="data" if (kv_seq and "data" in axes) else None,
        heads="model" if "model" in axes else None,
        ff="model" if "model" in axes else None,
        vocab="model" if "model" in axes else None,
        experts="model" if "model" in axes else None,
        fsdp="data" if (fsdp and "data" in axes) else None,
    )


def logical_spec(*logical_axes) -> tuple:
    """Resolve logical axis names to a spec under the current rules."""
    rules = current_rules()
    if rules is None:
        return ()
    out = []
    for ax in logical_axes:
        if ax is None:
            out.append(None)
        elif ax == "batch":
            b = tuple(a for a in rules.batch if a)
            out.append(b if b else None)
        else:
            out.append(rules.resolve(ax))
    return tuple(out)


def spec_placements(mesh, spec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` its axis names, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in axis_names(mesh))


def shard(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """Constrain ``x`` to the placements its logical axes resolve to, the
    counterpart of ``with_sharding_constraint``: ``x`` itself when no
    rules or mesh are active or ``x`` is not a DTensor (one thread-local
    read on the serving path), else ``x`` redistributed."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    placements = spec_placements(rules.mesh, _divisible(
        logical_spec(*logical_axes), tuple(x.shape), rules.mesh))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(rules.mesh, placements)


def _divisible(spec, shape: tuple, mesh) -> tuple:
    """``spec`` with the shardings of dims their axes do not divide
    dropped (None)."""
    sizes = mesh_shape(mesh)
    clean = []
    for size, ax in zip(shape, spec):
        if ax is None:
            clean.append(None)
            continue
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= sizes[a]
        clean.append(ax if size % n == 0 else None)
    return tuple(clean)


# ---------------------------------------------------------------------------
# Parameter sharding rules: tree-path regex -> logical axes per dim.
# Paths are "/"-joined dict keys; stacked layer params have a leading L dim
# which is never sharded.
# ---------------------------------------------------------------------------
# (regex, logical axes for each dim — matched against the *trailing* dims,
#  leading unmatched dims get None)
_PARAM_RULES = [
    (r"embed/tok$",            ("vocab", "fsdp")),
    (r"lm_head$",              ("fsdp", "vocab")),
    (r"attn/wq$",              ("fsdp", "heads")),
    (r"attn/wk$",              ("fsdp", "kv_heads")),   # resolved specially
    (r"attn/wv$",              ("fsdp", "kv_heads")),
    (r"attn/wo$",              ("heads", "fsdp")),
    (r"attn/bq$",              ("heads",)),
    (r"attn/bk$",              ("kv_heads",)),
    (r"attn/bv$",              ("kv_heads",)),
    (r"mlp/w_gate$",           ("fsdp", "ff")),
    (r"mlp/w_up$",             ("fsdp", "ff")),
    (r"mlp/w_down$",           ("ff", "fsdp")),
    (r"moe/router$",           ("fsdp", None)),
    # expert parallelism owns the model axis. Default: shard D over fsdp.
    # With rules.moe_ff set (2D EP), the per-expert FFN dim F is sharded
    # instead — contraction stays local, avoiding per-step weight gathers.
    (r"moe/w_gate$",           ("experts", "moe_d", "moe_f")),
    (r"moe/w_up$",             ("experts", "moe_d", "moe_f")),
    (r"moe/w_down$",           ("experts", "moe_f", "moe_d")),
    (r"ssm/in_proj$",          ("fsdp", "ff")),
    (r"ssm/out_proj$",         ("ff", "fsdp")),
    (r"ssm/(conv_w|conv_b|A_log|D|dt_bias|norm)$", (None,)),
    (r"(ln1|ln2|ln|final_norm|q_norm|k_norm)$", (None,)),
]


def _spec_for_path(path: str, shape: tuple, rules: AxisRules,
                   kv_shardable: bool) -> tuple:
    for pat, logical in _PARAM_RULES:
        if re.search(pat, path):
            dims = []
            for ax in logical:
                if ax == "kv_heads":
                    ax = "heads" if kv_shardable else None
                elif ax == "moe_f":
                    ax = "moe_ff" if rules.moe_ff else None
                elif ax == "moe_d":
                    ax = None if rules.moe_ff else "fsdp"
                if ax is None:
                    dims.append(None)
                else:
                    dims.append(rules.resolve(ax))
            # pad leading dims (stacked layer axis etc.) with None
            lead = len(shape) - len(dims)
            spec = [None] * lead + dims
            # drop illegal shardings (dim not divisible by axis size)
            return _divisible(spec, shape, rules.mesh)
    return ()  # replicate by default


def _paths(tree, prefix: tuple = ()):
    """(path, leaf) of nested dicts, keys joined by "/"."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def _tree_like(tree, values: dict, prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _tree_like(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    return values["/".join(prefix)]


def param_specs(params, rules: AxisRules, cfg=None):
    """Spec tree matching ``params`` (nested dicts of tensors, or of
    anything with ``.shape``)."""
    tp = mesh_shape(rules.mesh).get("model", 1) if rules.mesh else 1
    kv_shardable = bool(cfg is None or cfg.n_kv_heads == 0
                        or (cfg.n_kv_heads * cfg.resolved_head_dim) % max(
                            1, tp * cfg.resolved_head_dim) == 0)
    # KV projections are sharded over heads only when every shard gets whole
    # heads; otherwise replicate (standard GQA TP practice).
    if cfg is not None and cfg.n_kv_heads:
        kv_shardable = cfg.n_kv_heads % tp == 0
    return _tree_like(params, {
        path: _spec_for_path(path, tuple(leaf.shape), rules, kv_shardable)
        for path, leaf in _paths(params)})


class NamedSharding(NamedTuple):
    """Where a tensor lies: the mesh and one placement per mesh dim."""
    mesh: object
    placements: tuple


def named_sharding_tree(params, rules: AxisRules, cfg=None):
    specs = param_specs(params, rules, cfg)
    return _tree_like(specs, {
        path: NamedSharding(rules.mesh, spec_placements(rules.mesh, spec))
        for path, spec in _paths(specs)})


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def batch_sharding(mesh, specs_tree):
    """The ``NamedSharding`` of every leaf of a batch (tensors or
    ``TensorSpec``s): its leading dim split over the batch axes where
    they divide it, the rest replicated."""
    ba = batch_axes(mesh)
    sizes = mesh_shape(mesh)
    n = 1
    for a in ba:
        n *= sizes[a]

    def leaf(s):
        if len(s.shape) == 0:
            return NamedSharding(mesh, spec_placements(mesh, ()))
        b = s.shape[0]
        ax = ba if (b % n == 0 and b >= n) else None
        return NamedSharding(mesh, spec_placements(
            mesh, (ax,) + (None,) * (len(s.shape) - 1)))
    if isinstance(specs_tree, dict):
        return {k: batch_sharding(mesh, v) for k, v in specs_tree.items()}
    return leaf(specs_tree)


def place(tree, shardings):
    """Every leaf of ``tree`` distributed onto its ``NamedSharding``
    (``distribute_tensor``): a tensor is scattered from this rank's copy,
    a host array is converted first."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.array(tree))
    mesh, placements = shardings
    if t.device.type != "meta":
        t = t.to(mesh.device_type)
    return distribute_tensor(t, mesh, list(placements))


def _reshard_target(func, t, args) -> list:
    """Placements under which ``func`` can run on ``t``: a view keeps
    the shardings of the dims before the first one it changes and
    replicates the rest; any other op takes ``t`` replicated."""
    from torch.distributed.tensor import Replicate
    first = 0
    if (func.is_view or func.__name__.startswith("_unsafe_view.")) and \
            len(args) > 1 and isinstance(args[1], (list, tuple)):
        new = list(args[1])                     # a view to a new shape
        while (first < min(len(new), t.ndim)
               and new[first] == t.shape[first]):
            first += 1
    return [p if p.is_shard() and p.dim < first else Replicate()
            for p in t.placements]


class ReshardFallback(TorchDispatchMode):
    """Under this mode a DTensor op that DTensor cannot shard as its
    inputs lie (a view that splits or merges a sharded dim, an op with no
    sharding strategy) runs on its inputs resharded so that it can (the
    first DTensor input by ``_reshard_target``, the others replicated),
    as XLA's partitioner inserts the collectives a layout needs; an
    in-place op's result is then copied back into its first argument on
    that argument's placements. The redistributions run under the modes
    below it, so a ``StepCounter`` there counts their collectives.
    ``reshards`` counts the ops it resharded, by name."""

    def __init__(self):
        super().__init__()
        self.reshards = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # while this runs the mode is off the stack: the ops DTensor runs
        # on the local shards go to the modes below, not through here
        kwargs = kwargs or {}
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            # "Sharding propagation failed", "... no sharding strategy"
            if "harding" not in str(e):
                raise
        from torch.distributed.tensor import DTensor, Replicate
        self.reshards[str(func)] += 1
        first = next(a for a in tree_flatten((args, kwargs))[0]
                     if isinstance(a, DTensor))
        moved_args, moved_kwargs = tree_map_only(
            DTensor, lambda t: t.redistribute(
                t.device_mesh, _reshard_target(func, t, args) if t is first
                else [Replicate()] * t.device_mesh.ndim), (args, kwargs))
        out = func(*moved_args, **moved_kwargs)
        first_arg = func._schema.arguments[0].alias_info
        if first_arg is not None and first_arg.is_write and \
                isinstance(args[0], DTensor):
            target = args[0]
            target.copy_(moved_args[0].redistribute(target.device_mesh,
                                                    target.placements))
            return target
        return out


@contextlib.contextmanager
def on_mesh():
    """The context a step on placed leaves runs in: plain tensors the
    model makes (positions, masks) join DTensors as replicated, and an op
    DTensor cannot shard as its inputs lie is resharded
    (``ReshardFallback``). Yields the fallback, whose ``reshards`` say
    what it resharded."""
    from torch.distributed.tensor.experimental import implicit_replication
    fallback = ReshardFallback()
    with fallback, implicit_replication():
        yield fallback
