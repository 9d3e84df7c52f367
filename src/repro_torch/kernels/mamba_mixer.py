"""The Mamba2 mixer's elementwise chain: the hand-written CUDA kernels
``csrc/mamba_conv.cu`` and ``csrc/mamba_gate.cu`` and their wrappers.

Neither replaces a TPU kernel: the JAX package writes the causal conv
(``repro/models/ssm.py`` ``_causal_conv``) and the gated norm
(``_gated_norm``) in jnp, which XLA fuses on the TPU. Eager PyTorch ran
them as ~30 launches a layer over full-size temporaries; here they are
two, around ``ssd_scan``:

* ``mamba_conv`` (prefill): xbc = SiLU(causal depthwise conv + bias) in
  the model dtype, dt = softplus(dt + dt_bias) and A = -exp(A_log) in
  fp32. xbc and dt are column slices of the in_proj output, read through
  their strides.
* ``mamba_gate`` (prefill and decode): (y + D x) · SiLU(z), each B/C
  group's RMS, the norm weight, rounded once to the model dtype; z is
  read through its stride.

Both are bound by bytes; their sources say how they move fewer. Both
keep the plain versions' rounding points (``kernels/ref.py``
``mamba_conv_ref``, ``mamba_gate_ref``: each conv product and partial
sum, D x and y + D x in the model dtype, the norm's statistics in fp32),
so the two differ only in the order of the norm's sum and the SiLU's
exp: well within the dtype's tolerance, and the kernel path's logits
track the plain path's over a deep model. The wrappers take the plain
versions only for tensors that lie on the CPU.

Training: ``MambaConvFn`` and ``MambaGateFn`` (taken by ``kernels/ops``
for CUDA tensors under autograd) run the kernel forward and keep only
its inputs; their backward recomputes the plain version from them and
differentiates it with autograd. No backward kernel exists, and none is
mirrored: the reference trains through the chain's jnp. The gradient is
the plain composition's at the same inputs, and no fp32 temporaries of
the chain are kept between the passes.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_conv_ref, mamba_gate_ref

_CONV_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4
                  + [ctypes.c_int] * 11 + [ctypes.c_void_p])
_GATE_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4
                  + [ctypes.c_int] * 3 + [ctypes.c_float]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_count_lock = threading.Lock()
_conv_fn = None           # the C entries, once built and loaded
_gate_fn = None


def _codes(what: str, *ts) -> list:
    """The kernels' dtype codes of ``ts``."""
    try:
        return [_build.DTYPES[t.dtype] for t in ts]
    except KeyError:
        raise TypeError(f"{what}: unsupported dtypes "
                        f"{[t.dtype for t in ts]}") from None


def _on(what: str, dev: int, *ts) -> None:
    for t in ts:
        if t.get_device() != dev:
            raise ValueError(f"{what}: tensors on cuda:{dev} and {t.device}")


def mamba_conv(xbc: torch.Tensor, dt: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor, dt_bias: torch.Tensor,
               A_log: torch.Tensor) -> tuple:
    """xbc (B, S, C), dt (B, S, H), w (k, C), b (C,), dt_bias and A_log
    (H,) -> (SiLU(conv) (B, S, C) in xbc's dtype, softplus'd dt (B, S, H)
    fp32, A (H,) fp32)."""
    global _conv_fn
    if xbc.device.type == "cpu":
        return mamba_conv_ref(xbc, dt, w, b, dt_bias, A_log)
    if not xbc.is_cuda:
        raise ValueError(f"mamba_conv: xbc on {xbc.device}")
    dev = xbc.get_device()
    _on("mamba_conv", dev, dt, w, b, dt_bias, A_log)
    if xbc.dim() != 3 or dt.dim() != 3 or dt.shape[:2] != xbc.shape[:2]:
        raise ValueError(f"mamba_conv: xbc {tuple(xbc.shape)}, dt "
                         f"{tuple(dt.shape)}")
    B, S, C = xbc.shape
    H, k = dt.shape[2], w.shape[0]
    if w.shape != (k, C) or b.shape != (C,) or dt_bias.shape != (H,) \
            or A_log.shape != (H,):
        raise ValueError(f"mamba_conv: w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}, dt_bias {tuple(dt_bias.shape)}, "
                         f"A_log {tuple(A_log.shape)} for C {C}, H {H}")
    if xbc.stride(2) != 1 or dt.stride(2) != 1:
        raise ValueError("mamba_conv: xbc and dt need unit channel stride")
    w, b, dt_bias, A_log = (t.contiguous() for t in (w, b, dt_bias, A_log))
    codes = _codes("mamba_conv", xbc, dt, w, b, dt_bias, A_log)
    out = torch.empty((B, S, C), dtype=xbc.dtype, device=xbc.device)
    dt_out = torch.empty((B, S, H), dtype=torch.float32, device=xbc.device)
    A = torch.empty((H,), dtype=torch.float32, device=xbc.device)
    if _conv_fn is None:
        _conv_fn = _build.kernel("mamba_conv", "hydra_mamba_conv",
                                 _CONV_ARGTYPES)
    err = _conv_fn(
        xbc.data_ptr(), dt.data_ptr(), w.data_ptr(), b.data_ptr(),
        dt_bias.data_ptr(), A_log.data_ptr(), out.data_ptr(),
        dt_out.data_ptr(), A.data_ptr(), xbc.stride(0) if B > 1 else 0,
        xbc.stride(1), dt.stride(0) if B > 1 else 0, dt.stride(1), B, S, C,
        H, k, *codes, _build.stream(xbc))
    if err:
        _build.check(err, "mamba_conv")
    with _count_lock:
        mamba_conv.launches += 1
    return out, dt_out, A


mamba_conv.launches = 0   # kernel launches since the last reset


def _rows(t: torch.Tensor, din: int) -> torch.Tensor:
    """``t`` as (rows, din) with unit channel stride: a view wherever the
    leading dims are evenly strided (the served slices are)."""
    t = t.reshape(-1, din)
    return t if t.stride(1) == 1 else t.contiguous()


def mamba_gate(y: torch.Tensor, x: torch.Tensor, D: torch.Tensor,
               z: torch.Tensor, w: torch.Tensor, eps: float,
               groups: int = 1) -> torch.Tensor:
    """y, x (..., H, P), D (H,), z (..., H * P), w (H * P,) -> the gated,
    per-group normalised (..., H * P) in y's dtype."""
    global _gate_fn
    if y.device.type == "cpu":
        return mamba_gate_ref(y, x, D, z, w, eps, groups)
    if not y.is_cuda:
        raise ValueError(f"mamba_gate: y on {y.device}")
    dev = y.get_device()
    _on("mamba_gate", dev, x, D, z, w)
    H, P = y.shape[-2:]
    din, lead = H * P, y.shape[:-2]
    if x.shape != y.shape or z.shape != lead + (din,) or D.shape != (H,) \
            or w.shape != (din,):
        raise ValueError(f"mamba_gate: y {tuple(y.shape)}, x "
                         f"{tuple(x.shape)}, z {tuple(z.shape)}, D "
                         f"{tuple(D.shape)}, w {tuple(w.shape)}")
    if x.dtype != y.dtype or z.dtype != y.dtype:
        raise TypeError(f"mamba_gate: y {y.dtype}, x {x.dtype}, z {z.dtype}")
    if groups < 1 or din % groups:
        raise ValueError(f"mamba_gate: {groups} groups of {din} channels")
    y2, x2, z2 = _rows(y, din), _rows(x, din), _rows(z, din)
    D, w = D.contiguous(), w.contiguous()
    codes = _codes("mamba_gate", y, w, D)
    out = torch.empty(lead + (din,), dtype=y.dtype, device=y.device)
    if _gate_fn is None:
        _gate_fn = _build.kernel("mamba_gate", "hydra_mamba_gate",
                                 _GATE_ARGTYPES)
    err = _gate_fn(
        y2.data_ptr(), x2.data_ptr(), z2.data_ptr(), D.data_ptr(),
        w.data_ptr(), out.data_ptr(), y2.stride(0), x2.stride(0),
        z2.stride(0), y2.shape[0], din, H, groups, eps, *codes,
        _build.stream(y))
    if err:
        _build.check(err, "mamba_gate")
    with _count_lock:
        mamba_gate.launches += 1
    return out


mamba_gate.launches = 0   # kernel launches since the last reset


def _plain_grads(plain, ctx, grads, n_consts: int) -> tuple:
    """The gradients of ``plain`` (the plain version) at the inputs that
    ``ctx`` saved, for the output gradients ``grads``: its forward
    recomputed from them under autograd (the kernel path's backward)."""
    ins = [t.detach().requires_grad_(need) for t, need in
           zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        outs = plain(*ins, *ctx.consts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
    want = [t for t in ins if t.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs],
                                   want, [g for _, g in pairs],
                                   allow_unused=True) if pairs and want
               else ())
    return tuple(next(got, None) if t.requires_grad else None
                 for t in ins) + (None,) * n_consts


class MambaConvFn(torch.autograd.Function):
    """``mamba_conv`` on the kernel, differentiated through
    ``mamba_conv_ref`` (module docstring)."""

    @staticmethod
    def forward(ctx, xbc, dt, w, b, dt_bias, A_log):
        ctx.save_for_backward(xbc, dt, w, b, dt_bias, A_log)
        ctx.consts = ()
        return mamba_conv(xbc, dt, w, b, dt_bias, A_log)

    @staticmethod
    def backward(ctx, dxbc, ddt, dA):
        return _plain_grads(mamba_conv_ref, ctx, (dxbc, ddt, dA), 0)


class MambaGateFn(torch.autograd.Function):
    """``mamba_gate`` on the kernel, differentiated through
    ``mamba_gate_ref`` (module docstring)."""

    @staticmethod
    def forward(ctx, y, x, D, z, w, eps, groups):
        ctx.save_for_backward(y, x, D, z, w)
        ctx.consts = (eps, groups)
        return mamba_gate(y, x, D, z, w, eps, groups)

    @staticmethod
    def backward(ctx, dout):
        return _plain_grads(mamba_gate_ref, ctx, (dout,), 2)
