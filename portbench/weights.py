"""Weights made by the benchmark from the run's seed, on the card, in the
type they are served in, and handed alike to the program and
to the plain reference.

The tree is the layout the port's ``ModelProgram`` takes (nested dicts,
per-layer leaves stacked on a leading layer axis); the values are the
benchmark's own. Each leaf is one call on a generator seeded from (seed,
the leaf's path), so any leaf can be made again on its own.

Values: projections N(0, 1 / fan_in); the norms' weights (applied as
1 + w) and the conv bias N(0, 0.1^2); the conv taps N(0, 1 / taps);
Mamba2's own initialisation for the SSM's scalars: A = -exp(A_log) with
exp(A_log) uniform on [1, 16], dt_bias the inverse softplus of a dt
log-uniform on [1e-3, 1e-1], D = 1.
"""
from __future__ import annotations

import hashlib
import math

import torch


def shapes(cfg: dict) -> dict:
    """{path: (shape, kind)} of every leaf of the ``ssm`` family, in the
    program's tree order."""
    if cfg["family"] != "ssm":
        raise ValueError(f"weights for family {cfg['family']!r}")
    L, D, V = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    din = cfg["ssm_expand"] * D
    N, P = cfg["ssm_state"], cfg["ssm_head_dim"]
    H = din // P
    cd = din + 2 * N
    k = cfg["ssm_conv"]
    out = {
        "embed.tok": ((V, D), ("normal", D)),
        "layers.ln1": ((L, D), ("norm",)),
        "layers.ssm.in_proj": ((L, D, 2 * din + 2 * N + H), ("normal", D)),
        "layers.ssm.conv_w": ((L, k, cd), ("normal", k)),
        "layers.ssm.conv_b": ((L, cd), ("norm",)),
        "layers.ssm.A_log": ((L, H), ("A_log",)),
        "layers.ssm.D": ((L, H), ("ones",)),
        "layers.ssm.dt_bias": ((L, H), ("dt_bias",)),
        "layers.ssm.norm": ((L, din), ("norm",)),
        "layers.ssm.out_proj": ((L, din, D), ("normal", din)),
    }
    out["final_norm"] = ((D,), ("norm",))
    if not cfg["tie_embeddings"]:
        out["lm_head"] = ((D, V), ("normal", D))
    return out


def _leaf_seed(seed: int, path: str) -> int:
    h = hashlib.sha256(f"{int(seed)}:{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make_leaf(cfg: dict, seed: int, path: str, dtype, device) -> torch.Tensor:
    shape, kind = shapes(cfg)[path]
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


def make(cfg: dict, seed: int, dtype, device) -> dict:
    """The whole tree, one generator call per leaf."""
    return nest({p: make_leaf(cfg, seed, p, dtype, device)
                 for p in shapes(cfg)})
