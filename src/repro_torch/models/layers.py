"""Shared primitive layers: norms, init helpers, rotary embeddings."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut to [-2, 2] times
    ``fan_in ** -0.5``, drawn on the generator's device."""
    shape = tuple(shape)
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(fan_in ** -0.5).to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm(x, w, eps=eps)


def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float) -> torch.Tensor:
    """NeoX-style half-rotation rotary embedding, in fp32, cast back.

    x: (..., S, H, hd) or (..., H, hd) with matching positions (..., S)/(...,).
    """
    hd = x.shape[-1]
    half = hd // 2
    f32 = torch.float32
    log_theta = torch.log(torch.tensor(theta, dtype=f32, device=x.device))
    freq = torch.exp(-log_theta * torch.arange(0, half, dtype=f32,
                                                device=x.device) / half)
    angles = positions.to(f32)[..., None] * freq     # (..., S, half)
    angles = angles[..., None, :]                    # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    return table[tokens.long()].to(dtype)
