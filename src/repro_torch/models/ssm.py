"""Mamba2 (SSD) block: in_proj -> causal depthwise conv -> chunked SSD scan
-> gated RMSNorm -> out_proj. ``cfg.ssm_groups`` B/C groups (Mamba2's
n_groups): head h reads group h // (H / G), and the gated norm normalises
each group's d_inner / G channels on their own, as Zamba2's
``Zamba2RMSNormGated`` does. One group keeps B and C as (B, S, N).
The elementwise work around the scan is two ``kernels/ops`` entries:
``mamba_conv`` (the prefill's conv, SiLU, dt and A) and ``mamba_gate``
(the D skip and the gated norm, in prefill and decode).

Decode state per layer: conv window (B, k-1, conv_dim) in the model dtype
and SSM state (B, H, P, N) fp32. ``mamba_decode`` writes both into the
cache's layer slices in place, as attention decode writes its K/V row.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.launch.sharding import shard
from repro_torch.models.layers import dense_init


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg, stack: int | None = None,
               dtype=torch.float32, device=None):
    d, din, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    cd = conv_dim(cfg)
    lead = (stack,) if stack else ()
    dev = gen.device if device is None else device
    full = lambda shape, v: torch.full(lead + shape, v, dtype=dtype,
                                       device=dev)
    conv_w = dense_init(gen, lead + (cfg.ssm_conv, cd),
                        device=dev).mul_(0.1).to(dtype)
    # in_proj -> [z (din), xBC (din + 2 G N), dt (H)]
    return {
        "in_proj": dense_init(gen, lead + (d, din + cd + H),
                              dtype=dtype, device=dev),
        "conv_w": conv_w,
        "conv_b": full((cd,), 0.0),
        "A_log": full((H,), 0.0),           # A = -exp(A_log) = -1
        "D": full((H,), 1.0),
        "dt_bias": full((H,), -1.0),        # softplus(-1) ~ 0.31
        "norm": full((din,), 0.0),
        "out_proj": dense_init(gen, lead + (din, d), dtype=dtype, device=dev),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg):
    din, cd = cfg.d_inner, conv_dim(cfg)
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + cd]
    dt = zxbcdt[..., din + cd:]
    return z, xbc, dt


def _split_xbc(xbc: torch.Tensor, cfg):
    """x, B, C: column slices of xbc (views); with G > 1 groups, B and C
    (..., G, N)."""
    din, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    xin = xbc[..., :din]
    Bm, Cm = xbc[..., din:din + G * N], xbc[..., din + G * N:]
    if G > 1:
        Bm, Cm = Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))
    return xin, Bm, Cm


def mamba_prefill(p, x: torch.Tensor, cfg, *, return_state: bool = False):
    """x (B,S,D) -> (out (B,S,D), (conv_state, ssm_state) or None)."""
    B, S, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    dt_ = x.dtype
    zxbcdt = shard(x @ p["in_proj"].to(dt_), "batch", None, "ff")
    z, xbc_pre, dt = _split_proj(zxbcdt, cfg)
    xbc, dt, A = ops.mamba_conv(xbc_pre, dt, p["conv_w"], p["conv_b"],
                                p["dt_bias"], p["A_log"])
    # column slices of xbc: the scan reads them through their strides
    xin, Bm, Cm = _split_xbc(xbc, cfg)
    xh = xin.reshape(B, S, H, P)
    res = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=min(cfg.ssm_chunk, S),
                       return_state=return_state)
    y, state = res if return_state else (res, None)
    y = ops.mamba_gate(y, xh, p["D"], z, p["norm"], cfg.norm_eps,
                       cfg.ssm_groups)
    out = shard(y @ p["out_proj"].to(dt_), "batch", None, None)
    if not return_state:
        return out, None
    k = cfg.ssm_conv
    conv_state = (xbc_pre[:, S - (k - 1):, :] if S >= k - 1
                  else F.pad(xbc_pre, (0, 0, k - 1 - S, 0)))
    return out, (conv_state, state)


def mamba_decode(p, x1: torch.Tensor, cfg, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor) -> torch.Tensor:
    """One token. x1 (B,1,D); conv_state (B,k-1,cd) and ssm_state
    (B,H,P,N) fp32 are this layer's cache slices, updated in place.
    Returns out (B,1,D)."""
    B = x1.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    dt_ = x1.dtype
    z, xbc_pre, dt = _split_proj((x1 @ p["in_proj"].to(dt_))[:, 0], cfg)
    # conv over [conv_state ; xbc_pre]
    win = torch.cat([conv_state, xbc_pre[:, None, :]], dim=1)   # (B,k,cd)
    xbc = F.silu(torch.einsum("bkc,kc->bc", win, p["conv_w"].to(dt_))
                 + p["conv_b"].to(dt_))
    conv_state.copy_(win[:, 1:, :])
    xin, Bm, Cm = _split_xbc(xbc, cfg)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(B, H, P)
    y, new_state = ops.ssd_decode(xh, dt, A, Bm, Cm, ssm_state)
    ssm_state.copy_(new_state)
    y = ops.mamba_gate(y, xh, p["D"], z, p["norm"], cfg.norm_eps,
                       cfg.ssm_groups)
    return (y @ p["out_proj"].to(dt_))[:, None, :]
