"""Public kernel entry points with one dispatch rule.

Dispatch policy (``kernel_mode()``, read from ``REPRO_TORCH_KERNEL_MODE``):
  * ``auto`` — the hand-written CUDA kernel for a CUDA tensor, the plain
               PyTorch version (``kernels/ref.py``) for a CPU tensor.
  * ``cuda`` — the CUDA kernel; a CPU tensor raises.
  * ``ref``  — the plain PyTorch version on any device. It exists so the
               kernels can be compared with it on the card; nothing on
               the serving path sets it.

There is no fallback: a CUDA tensor goes through its kernel or raises.

A DTensor (the train launcher's placed leaves, the dry-run's meta
tensors) runs its kernel, or in ``ref`` mode its plain version, on the
local shards (``local_map``), since the kernels take plain tensors. A
shard is exact where the split is over rows: the rows of ``rmsnorm``,
the batch or the heads of attention (q, k and v split alike; k and v are
first repeated to one head per q head when their heads do not split
over the mesh dim q's do), the batch of ``ssd_scan``. Any other
placement is redistributed to replicated first.
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

Each entry point is one ``kernel`` span of the serving step track
(``core/tracing.step_span``), its ``name`` attribute the entry's name;
with no step recording on the thread it is the shared no-op span.
"""
from __future__ import annotations

import os

import torch

from repro_torch.core.tracing import step_span
from repro_torch.device import is_dtensor
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
def _on_shards(fn, args: tuple, split: dict, out_split: list, lead: int = 0):
    """``fn(*args)`` on the local shards of DTensor ``args`` (None for an
    argument that is not a tensor), for each mesh dim split as argument
    ``lead`` is when that split is one ``split`` names, else replicated.

    ``split`` maps a kind of split to the dim it takes in each argument
    (None: the argument is not split by it, it is replicated and its
    gradient is a partial sum); ``out_split`` gives, per output, the dim
    each kind takes. A split is kept only where the mesh dim divides
    that dim in every argument."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = args[lead].device_mesh
    kinds = []
    for i, p in enumerate(args[lead].placements):
        kind = None
        if p.is_shard():
            for name, dims in split.items():
                if dims[lead] == p.dim and all(
                        d is None or a.shape[d] % mesh.size(i) == 0
                        for a, d in zip(args, dims) if a is not None):
                    kind = name
        kinds.append(kind)

    def placements(dims, grad=False):
        return [Shard(dims[k]) if k and dims[k] is not None
                else Partial() if k and grad else Replicate()
                for k in kinds]

    ins, grads = [], []
    for j, a in enumerate(args):
        dims = {k: d[j] for k, d in split.items()}
        ins.append(None if a is None else placements(dims))
        grads.append(None if a is None else placements(dims, grad=True))
    outs = [placements(d) for d in out_split]
    return local_map(fn, out_placements=outs[0] if len(outs) == 1
                     else tuple(outs), in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _kv_for_sharded_heads(q, k, v, head_dim: int):
    """k and v repeated to one head per q head where q's heads are split
    over a mesh dim that does not split k's (group 1 on every shard)."""
    group = q.shape[head_dim] // k.shape[head_dim]
    mesh = q.device_mesh
    if group == 1 or not any(
            p.is_shard(head_dim) and k.shape[head_dim] % mesh.size(i)
            for i, p in enumerate(q.placements)):
        return k, v
    return (k.repeat_interleave(group, dim=head_dim),
            v.repeat_interleave(group, dim=head_dim))


def rmsnorm(x, w, eps: float = 1e-5):
    with step_span("kernel", "rmsnorm"):
        if is_dtensor(x):
            rows = tuple(range(x.ndim - 1))
            return _on_shards(lambda a, b: rmsnorm(a, b, eps), (x, w),
                              {f"row{d}": (d, None) for d in rows},
                              [{f"row{d}": d for d in rows}])
        if _use_kernel(x):
            if _needs_grad(x, w):
                return _rmsnorm.RMSNormFn.apply(x, w, eps)
            return _rmsnorm.rmsnorm(x, w, eps=eps)
        return _ref.rmsnorm_ref(x, w, eps)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    with step_span("kernel", "flash_attention"):
        if is_dtensor(q):
            k, v = _kv_for_sharded_heads(q, k, v, 2)
            return _on_shards(
                lambda a, b, c: flash_attention(a, b, c, causal=causal,
                                                window=window, scale=scale),
                (q, k, v), {"batch": (0, 0, 0), "heads": (2, 2, 2)},
                [{"batch": 0, "heads": 2}])
        if _use_kernel(q):
            if _needs_grad(q, k, v):
                return _flash.FlashAttentionFn.apply(q, k, v, causal, window,
                                                     scale)
            return _flash.flash_attention(q, k, v, causal=causal,
                                          window=window, scale=scale)
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *, window=None,
                     scale=None):
    with step_span("kernel", "decode_attention"):
        if is_dtensor(q):
            k_cache, v_cache = _kv_for_sharded_heads(q, k_cache, v_cache, 1)
            return _on_shards(
                lambda a, b, c, n: decode_attention(
                    a, b, c, n, window=window, scale=scale),
                (q, k_cache, v_cache, lengths),
                {"batch": (0, 0, 0, 0), "heads": (1, 2, 2, None)},
                [{"batch": 0, "heads": 1}])
        if _use_kernel(q):
            if _needs_grad(q, k_cache, v_cache):
                raise missing_backward("decode_attention")
            return _decode.decode_attention(q, k_cache, v_cache, lengths,
                                            window=window, scale=scale)
        return _ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                         window=window, scale=scale)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=64, init_state=None,
             return_state=False):
    with step_span("kernel", "ssd_scan"):
        if is_dtensor(x):
            return _on_shards(
                lambda x_, dt_, A_, B_, C_, s_: ssd_scan(
                    x_, dt_, A_, B_, C_, chunk=chunk, init_state=s_,
                    return_state=return_state),
                (x, dt, A, Bm, Cm, init_state),
                {"batch": (0, 0, None, 0, 0, 0)},
                [{"batch": 0}, {"batch": 0}] if return_state
                else [{"batch": 0}])
        if _use_kernel(x):
            more = (dt, A, Bm, Cm) + (() if init_state is None
                                      else (init_state,))
            if _needs_grad(x, *more):
                return _ssd.SsdScanFn.apply(x, dt, A, Bm, Cm, init_state,
                                            chunk, return_state)
            return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                 init_state=init_state,
                                 return_state=return_state)
        return _ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                 init_state=init_state,
                                 return_state=return_state)


def ssd_decode(x, dt, A, Bm, Cm, state):
    with step_span("kernel", "ssd_decode"):
        return _ref.ssd_decode_ref(x, dt, A, Bm, Cm, state)
