"""Shared primitive layers: norms, init helpers, rotary embeddings."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import is_dtensor
from repro_torch.kernels import ops


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut to [-2, 2] times
    ``fan_in ** -0.5``, drawn on ``device`` (the generator's unless
    given: a CPU generator draws ``meta`` tensors, which hold no data)."""
    shape = tuple(shape)
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    t = torch.empty(shape, dtype=torch.float32,
                    device=gen.device if device is None else device)
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
    # a fill on the device, not a copy from the host: a CUDA graph
    # captures it (theta rounds to fp32 as the copy's would)
    log_theta = torch.log(torch.full((), theta, dtype=f32,
                                     device=x.device))
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
    """Rows of ``table`` by ``tokens`` (``F.embedding``: its backward is
    the embedding backward, which DTensor shards by the vocab; an index's
    backward, ``index_put``, has no working strategy there). From a
    vocab-sharded DTensor table the rows are a masked partial sum, which
    DTensor can reduce only once, so it is reduced here, before the rows
    have two readers (the residual and the norm). A table split over its
    width (FSDP) is gathered to whole rows first: DTensor's masked sum
    keeps the mask of the tokens as they lie, which no longer fits the
    rows once the lookup has moved the tokens."""
    if is_dtensor(table):
        from torch.distributed.tensor import Replicate
        table = table.redistribute(table.device_mesh, [
            p if p.is_shard(0) else Replicate() for p in table.placements])
    out = F.embedding(tokens.long(), table)
    if is_dtensor(out) and any(p.is_partial() for p in out.placements):
        from torch.distributed.tensor import Replicate
        out = out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return out.to(dtype)
