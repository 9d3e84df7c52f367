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
