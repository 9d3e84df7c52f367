"""Plain float32 pieces shared by the reference models: the norm and the
matrix products in a chosen precision.

Imports only torch. Float32 products run with TF32 off (``fp32_mode``).
``precision="fp8"`` is the control: each product's operands rounded to
float8 e4m3 (activations by row, weights by output column, each with its
own scale), the sum in float32, as an fp8 path would compute it.
"""
from __future__ import annotations

import contextlib

import torch

F32 = torch.float32


@contextlib.contextmanager
def fp32_mode():
    """Float32 products in float32, not TF32, while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _q8(t: torch.Tensor, dim: int, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    top = torch.finfo(fmt).max
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = top / amax
    return (t * s).to(fmt).to(F32) / s


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., K) @ w (K, N), both float32, in ``precision``."""
    if precision == "fp32":
        return x @ w
    if precision == "fp8":
        return _q8(x, -1) @ _q8(w, 0)
    raise ValueError(f"precision {precision!r}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * (1 + w)."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)
