"""Weights made by the benchmark from the run's seed, on the card, in the
type they are served in, and handed alike to the program and
to the plain reference.

The layout is the family's: ``reference/<family>.py`` gives ``shapes(cfg)``
({path: (shape, kind)}, in the program's tree order), beside the math
that reads those leaves, and the registry finds it by the
configuration's ``family``. The tree is the one the port's
``ModelProgram`` takes (nested dicts, per-layer leaves stacked on a
leading layer axis); the values are the benchmark's own. Each leaf is one
call on a generator seeded from (seed, the leaf's path), so any leaf can
be made again on its own.

Value kinds: ``normal``, N(0, 1 / fan_in), for projections; ``norm``,
N(0, 0.1^2), for the norms' weights (applied as 1 + w) and biases;
``ones``; and Mamba2's own initialisation for the SSM's scalars:
``A_log`` with exp(A_log) uniform on [1, 16] (A = -exp(A_log)),
``dt_bias`` the inverse softplus of a dt log-uniform on [1e-3, 1e-1].
"""
from __future__ import annotations

import hashlib
import math

import torch


def layout(registry, cfg: dict) -> dict:
    """{path: (shape, kind)} of every leaf of ``cfg``'s family."""
    return registry.reference(cfg).shapes(cfg)


def _leaf_seed(seed: int, path: str) -> int:
    h = hashlib.sha256(f"{int(seed)}:{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make_leaf(seed: int, path: str, leaf: tuple, dtype,
              device) -> torch.Tensor:
    """The leaf at ``path`` of a layout, ``leaf`` its (shape, kind)."""
    shape, kind = leaf
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path))
    kw = dict(generator=gen, device=device)
    name = kind[0]
    if name == "normal":
        return torch.randn(shape, dtype=dtype, **kw).mul_(kind[1] ** -0.5)
    if name == "norm":
        return torch.randn(shape, dtype=dtype, **kw).mul_(0.1)
    if name == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    u = torch.rand(shape, dtype=torch.float32, **kw)
    if name == "A_log":
        return torch.log(1.0 + 15.0 * u).to(dtype)
    if name == "dt_bias":
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    raise ValueError(name)


def nest(flat: dict) -> dict:
    """{"a.b": t} -> {"a": {"b": t}}."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    """The inverse of ``nest``, in the tree's order."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "."))
        else:
            out[path] = v
    return out


def make(registry, cfg: dict, seed: int, dtype, device) -> dict:
    """The whole tree, one generator call per leaf."""
    return nest({p: make_leaf(seed, p, leaf, dtype, device)
                 for p, leaf in layout(registry, cfg).items()})
