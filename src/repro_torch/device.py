"""Device resolution shared by every entry point of the port.

The port runs on the GPU. ``device=None`` means CUDA, and with no GPU
that raises instead of silently running on the CPU; the CPU is used only
when a caller asks for it (the tests pass ``device="cpu"``).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no GPU is visible; "
                "pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no GPU is visible")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ArchConfig.dtype`` string -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; a plain tensor answers without
    importing DTensor (one type check on the serving path)."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local(x):
    """This rank's shard of a DTensor (in-place ops on it write through to
    the DTensor), or ``x`` itself."""
    return x.to_local() if is_dtensor(x) else x


def reduce_shards(value: torch.Tensor, like, op: str = "sum"):
    """A value computed on ``like``'s local shard, combined (``op``: sum
    or max) over the mesh dims ``like`` is split on; ``value`` itself
    when ``like`` is a plain tensor. Replicated dims hold copies and are
    not combined."""
    if not is_dtensor(like):
        return value
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if any(p.is_partial() for p in like.placements):
        raise ValueError("reduce_shards: a partial DTensor has no local "
                         "value of its own; redistribute it first")
    return DTensor.from_local(
        value, like.device_mesh,
        [Partial(op) if p.is_shard() else Replicate()
         for p in like.placements], run_check=False).full_tensor()
