"""Plain-PyTorch oracles for the hand-written kernels.

Transcribed from ``repro.kernels.ref`` with its rounding points kept:
q is scaled in q's dtype, logits are accumulated in fp32, the softmax
probabilities are cast back to q's dtype before the PV product, and
masks use ``NEG_INF = -1e30`` (not ``-inf``), so a row with no valid key
averages V uniformly instead of giving NaN.

These are the CPU path of every kernel wrapper and the yardstick that
``chip_smoke.py`` holds each CUDA kernel to on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    # jnp: q * jnp.asarray(scale, q.dtype) — the scale is rounded to q's
    # dtype first, and the product is rounded to q's dtype
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(dtype)


# ---------------------------------------------------------------------------
# Flash attention (prefill): GQA + causal + optional sliding window
# ---------------------------------------------------------------------------
def flash_attention_ref(q: torch.Tensor,      # (B, S, Hq, hd)
                        k: torch.Tensor,      # (B, S, Hkv, hd)
                        v: torch.Tensor,      # (B, S, Hkv, hd)
                        *, causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5

    qg = _scaled_q(q, scale).reshape(B, S, Hkv, group, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype).float(), v.float())
    return out.reshape(B, S, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention: one query token against a (possibly partial) KV cache
# ---------------------------------------------------------------------------
def decode_attention_ref(q: torch.Tensor,        # (B, Hq, hd)
                         k_cache: torch.Tensor,  # (B, S, Hkv, hd)
                         v_cache: torch.Tensor,  # (B, S, Hkv, hd)
                         lengths: torch.Tensor,  # (B,) valid entries per row
                         *, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    B, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5

    qg = _scaled_q(q, scale).reshape(B, Hkv, group, hd)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
    kpos = torch.arange(S, device=q.device)[None, :]           # (1, S)
    lens = lengths.to(torch.int64)[:, None]
    valid = kpos < lens                                        # (B, S)
    if window is not None:
        valid &= kpos > (lens - 1 - window)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(q.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Hq, hd).to(q.dtype)
