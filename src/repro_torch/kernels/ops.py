"""Public kernel entry points with one dispatch rule.

Dispatch policy (``kernel_mode()``, read from ``REPRO_TORCH_KERNEL_MODE``):
  * ``auto`` — the hand-written CUDA kernel for a CUDA tensor, the plain
               PyTorch version (``kernels/ref.py``) for a CPU tensor.
  * ``cuda`` — the CUDA kernel; a CPU tensor raises.
  * ``ref``  — the plain PyTorch version on any device. It exists so the
               kernels can be compared with it on the card; nothing on
               the serving path sets it.

There is no fallback: a CUDA tensor goes through its kernel or raises.
``ssd_decode`` is the plain version on every device and in every mode, as
the reference's is: a single-token state update is no kernel there.

Under autograd (grad mode on and an input that requires grad) a CUDA
tensor that takes the kernel route goes through the kernel's
``torch.autograd.Function``, whose backward is a hand-written kernel too:
``rmsnorm``, ``flash_attention`` and ``ssd_scan`` have one, so every
family trains on the card. ``decode_attention`` is serving only (the
reference never differentiates it) and raises ``NotImplementedError``
there, so no kernel output silently lacks a gradient (its output is
written by a ctypes call and carries no ``grad_fn``). The serving path
runs under ``no_grad``/``inference_mode`` and costs one flag read more.
The CPU route is the plain version under ordinary autograd.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import ssd_scan as _ssd

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


def _needs_grad(x, *more) -> bool:
    """A CUDA tensor under autograd: the kernel route must carry a
    gradient. One flag read under no_grad / inference_mode."""
    return torch.is_grad_enabled() and x.is_cuda and (
        x.requires_grad or any(t.requires_grad for t in more))


def missing_backward(kernel: str) -> NotImplementedError:
    return NotImplementedError(
        f"{kernel}: serving only, with no backward kernel, so it cannot run "
        f"under autograd on the card")


# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps: float = 1e-5):
    if _use_kernel(x):
        if _needs_grad(x, w):
            return _rmsnorm.RMSNormFn.apply(x, w, eps)
        return _rmsnorm.rmsnorm(x, w, eps=eps)
    return _ref.rmsnorm_ref(x, w, eps)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    if _use_kernel(q):
        if _needs_grad(q, k, v):
            return _flash.FlashAttentionFn.apply(q, k, v, causal, window,
                                                 scale)
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=scale)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *, window=None,
                     scale=None):
    if _use_kernel(q):
        if _needs_grad(q, k_cache, v_cache):
            raise missing_backward("decode_attention")
        return _decode.decode_attention(q, k_cache, v_cache, lengths,
                                        window=window, scale=scale)
    return _ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                     window=window, scale=scale)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=64, init_state=None,
             return_state=False):
    if _use_kernel(x):
        more = (dt, A, Bm, Cm) + (() if init_state is None else (init_state,))
        if _needs_grad(x, *more):
            return _ssd.SsdScanFn.apply(x, dt, A, Bm, Cm, init_state, chunk,
                                        return_state)
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                             init_state=init_state, return_state=return_state)
    return _ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                             init_state=init_state, return_state=return_state)


def ssd_decode(x, dt, A, Bm, Cm, state):
    return _ref.ssd_decode_ref(x, dt, A, Bm, Cm, state)
