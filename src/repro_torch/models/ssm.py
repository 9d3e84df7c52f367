"""Mamba2 (SSD) block: in_proj -> causal depthwise conv -> chunked SSD scan
-> gated RMSNorm -> out_proj. Single B/C group (n_groups=1).

Decode state per layer: conv window (B, k-1, conv_dim) in the model dtype
and SSM state (B, H, P, N) fp32. ``mamba_decode`` writes both into the
cache's layer slices in place, as attention decode writes its K/V row.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg, stack: int | None = None,
               dtype=torch.float32):
    d, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cd = conv_dim(cfg)
    lead = (stack,) if stack else ()
    full = lambda shape, v: torch.full(lead + shape, v, dtype=dtype,
                                       device=gen.device)
    conv_w = dense_init(gen, lead + (cfg.ssm_conv, cd)).mul_(0.1).to(dtype)
    # in_proj -> [z (din), xBC (din + 2N), dt (H)]
    return {
        "in_proj": dense_init(gen, lead + (d, 2 * din + 2 * N + H),
                              dtype=dtype),
        "conv_w": conv_w,
        "conv_b": full((cd,), 0.0),
        "A_log": full((H,), 0.0),           # A = -exp(A_log) = -1
        "D": full((H,), 1.0),
        "dt_bias": full((H,), -1.0),        # softplus(-1) ~ 0.31
        "norm": full((din,), 0.0),
        "out_proj": dense_init(gen, lead + (din, d), dtype=dtype),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, xbc (B,S,C), w (k,C), b (C,): k shifted
    multiply-adds in xbc's dtype, then SiLU, as the reference writes it.
    (``F.conv1d`` would run fp32 through cuDNN in TF32 on the card and
    round elsewhere than the reference.)"""
    k, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i].to(xbc.dtype) for i in range(k))
    return F.silu(out + b.to(xbc.dtype))


def _split_proj(zxbcdt: torch.Tensor, cfg):
    din, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:2 * din + 2 * N]
    dt = zxbcdt[..., 2 * din + 2 * N:]
    return z, xbc, dt


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                eps: float) -> torch.Tensor:
    g = y.float() * F.silu(z.float())
    var = torch.mean(g * g, dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * (1.0 + w.float())).to(y.dtype)


def _dt_and_A(p, dt: torch.Tensor):
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["A_log"].float())


def mamba_prefill(p, x: torch.Tensor, cfg, *, return_state: bool = False):
    """x (B,S,D) -> (out (B,S,D), (conv_state, ssm_state) or None)."""
    B, S, _ = x.shape
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dt_ = x.dtype
    z, xbc_pre, dt = _split_proj(x @ p["in_proj"].to(dt_), cfg)
    xbc = _causal_conv(xbc_pre, p["conv_w"], p["conv_b"])
    # column slices of xbc: the scan reads them through their strides
    xin, Bm, Cm = xbc[..., :din], xbc[..., din:din + N], xbc[..., din + N:]
    dt, A = _dt_and_A(p, dt)
    xh = xin.reshape(B, S, H, P)
    res = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=min(cfg.ssm_chunk, S),
                       return_state=return_state)
    y, state = res if return_state else (res, None)
    y = y + p["D"].to(dt_)[None, None, :, None] * xh
    y = _gated_norm(y.reshape(B, S, din), z, p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
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
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dt_ = x1.dtype
    z, xbc_pre, dt = _split_proj((x1 @ p["in_proj"].to(dt_))[:, 0], cfg)
    # conv over [conv_state ; xbc_pre]
    win = torch.cat([conv_state, xbc_pre[:, None, :]], dim=1)   # (B,k,cd)
    xbc = F.silu(torch.einsum("bkc,kc->bc", win, p["conv_w"].to(dt_))
                 + p["conv_b"].to(dt_))
    conv_state.copy_(win[:, 1:, :])
    xin, Bm, Cm = xbc[..., :din], xbc[..., din:din + N], xbc[..., din + N:]
    dt, A = _dt_and_A(p, dt)
    xh = xin.reshape(B, H, P)
    y, new_state = ops.ssd_decode(xh, dt, A, Bm, Cm, ssm_state)
    ssm_state.copy_(new_state)
    y = y + p["D"].to(dt_)[None, :, None] * xh
    y = _gated_norm(y.reshape(B, din), z, p["norm"], cfg.norm_eps)
    return (y @ p["out_proj"].to(dt_))[:, None, :]
