"""Public kernel entry points with one dispatch rule.

Dispatch policy (``kernel_mode()``, read from ``REPRO_TORCH_KERNEL_MODE``):
  * ``auto`` — the hand-written CUDA kernel for a CUDA tensor, the plain
               PyTorch version (``kernels/ref.py``) for a CPU tensor.
  * ``cuda`` — the CUDA kernel; a CPU tensor raises.
  * ``ref``  — the plain PyTorch version on any device. It exists so the
               kernels can be compared with it on the card; nothing on
               the serving path sets it.

There is no fallback: a CUDA tensor goes through its kernel or raises.
"""
from __future__ import annotations

import os

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rmsnorm

MODE_ENV = "REPRO_TORCH_KERNEL_MODE"
MODES = ("auto", "cuda", "ref")
_mode_override: str | None = None


def set_kernel_mode(mode: str | None) -> None:
    """Process-wide override of ``REPRO_TORCH_KERNEL_MODE`` (None clears)."""
    global _mode_override
    if mode is not None and mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    _mode_override = mode


def kernel_mode() -> str:
    mode = _mode_override or os.environ.get(MODE_ENV, "auto")
    if mode not in MODES:
        raise ValueError(f"{MODE_ENV}={mode!r} not in {MODES}")
    return mode


def _use_kernel(x) -> bool:
    mode = kernel_mode()
    if mode == "ref":
        return False
    if mode == "cuda" and not x.is_cuda:
        raise RuntimeError(
            f"kernel mode 'cuda' needs CUDA tensors, got one on {x.device}")
    return True


# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps: float = 1e-5):
    if _use_kernel(x):
        return _rmsnorm.rmsnorm(x, w, eps=eps)
    return _ref.rmsnorm_ref(x, w, eps)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    if _use_kernel(q):
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=scale)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *, window=None,
                     scale=None):
    if _use_kernel(q):
        return _decode.decode_attention(q, k_cache, v_cache, lengths,
                                        window=window, scale=scale)
    return _ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                     window=window, scale=scale)
