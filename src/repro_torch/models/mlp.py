"""Feed-forward variants: SwiGLU (silu), GeGLU (gelu), squared-ReLU.

The products are plain ``torch.matmul``, as the reference leaves them to
XLA."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def is_gated(activation: str) -> bool:
    return activation in ("silu", "gelu")


def init_mlp(gen: torch.Generator, cfg, stack: int | None = None,
             dtype=torch.float32):
    d, f = cfg.d_model, cfg.d_ff
    lead = (stack,) if stack else ()
    p = {"w_up": dense_init(gen, lead + (d, f), dtype=dtype),
         "w_down": dense_init(gen, lead + (f, d), dtype=dtype)}
    if is_gated(cfg.activation):
        p["w_gate"] = dense_init(gen, lead + (d, f), dtype=dtype)
    return p


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def apply_mlp(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    dt = x.dtype
    up = x @ p["w_up"].to(dt)
    if is_gated(cfg.activation):
        h = _act(x @ p["w_gate"].to(dt), cfg.activation) * up
    else:
        h = _act(up, cfg.activation)
    return h @ p["w_down"].to(dt)
