"""Feed-forward variants: SwiGLU (silu), GeGLU (gelu: tanh GELU, as
jax.nn.gelu; gelu_exact: erf GELU, as Zamba2's published "gelu"),
squared-ReLU.

The products are plain ``torch.matmul``, as the reference leaves them to
XLA."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.sharding import shard
from repro_torch.models.layers import dense_init


def is_gated(activation: str) -> bool:
    return activation in ("silu", "gelu", "gelu_exact")


def init_mlp(gen: torch.Generator, cfg, stack: int | None = None,
             dtype=torch.float32, device=None):
    d, f = cfg.d_model, cfg.d_ff
    lead = (stack,) if stack else ()
    kw = dict(dtype=dtype, device=device)
    p = {"w_up": dense_init(gen, lead + (d, f), **kw),
         "w_down": dense_init(gen, lead + (f, d), **kw)}
    if is_gated(cfg.activation):
        p["w_gate"] = dense_init(gen, lead + (d, f), **kw)
    return p


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    if kind == "gelu_exact":
        return F.gelu(x)
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def apply_mlp(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    dt = x.dtype
    up = shard(x @ p["w_up"].to(dt), "batch", None, "ff")
    if is_gated(cfg.activation):
        h = _act(x @ p["w_gate"].to(dt), cfg.activation) * up
    else:
        h = _act(up, cfg.activation)
    return shard(h @ p["w_down"].to(dt), "batch", None, None)


def apply_adapted_mlp(p, x: torch.Tensor, cfg, down: torch.Tensor,
                      up: torch.Tensor) -> torch.Tensor:
    """The gated MLP with a low-rank adapter on its gate/up projection, as
    Zamba2's shared MLP: [gate ; up] = x [W_gate ; W_up] + (x down) up,
    then act(gate) * up times W_down. x (B, S, D); down (D, r), up (r,
    2 d_ff)."""
    dt, f = x.dtype, cfg.d_ff
    lo = (x @ down.to(dt)) @ up.to(dt)
    gate = x @ p["w_gate"].to(dt) + lo[..., :f]
    h = _act(gate, cfg.activation) * (x @ p["w_up"].to(dt) + lo[..., f:])
    return h @ p["w_down"].to(dt)
