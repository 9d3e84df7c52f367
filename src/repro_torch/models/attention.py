"""GQA attention: prefill path + KV-cache decode path.

Supports grouped-query attention, QKV bias, rotary embeddings and static
(Python int) sliding windows. The decode path writes the new K/V row into
the cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rotary

# "no window" sentinel: the reference's int32.max // 2. The kernels apply
# it literally as a window, which masks nothing.
GLOBAL_WINDOW = 1073741823


def init_attention(gen: torch.Generator, cfg, stack: int | None = None,
                   dtype=torch.float32):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    lead = (stack,) if stack else ()
    p = {
        "wq": dense_init(gen, lead + (d, hq * hd), dtype=dtype),
        "wk": dense_init(gen, lead + (d, hkv * hd), dtype=dtype),
        "wv": dense_init(gen, lead + (d, hkv * hd), dtype=dtype),
        "wo": dense_init(gen, lead + (hq * hd, d), in_axis=-2, dtype=dtype),
    }
    if cfg.qkv_bias:
        zeros = lambda n: torch.zeros(lead + (n,), dtype=dtype,
                                      device=gen.device)
        p["bq"], p["bk"], p["bv"] = zeros(hq * hd), zeros(hkv * hd), \
            zeros(hkv * hd)
    return p


def _project_qkv(p, x: torch.Tensor, cfg):
    """x: (B, S, D) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd)."""
    B, S, _ = x.shape
    dt = x.dtype
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:          # the bias is added in x's dtype, after the product
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return (q.reshape(B, S, cfg.n_heads, hd),
            k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


def attention_prefill(p, x: torch.Tensor, cfg, positions: torch.Tensor,
                      window: int | None = None):
    """Full-sequence attention. Returns (out (B,S,D), (k, v) for the cache)."""
    q, k, v = _project_qkv(p, x, cfg)
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim)
    return out @ p["wo"].to(x.dtype), (k, v)


def attention_decode(p, x1: torch.Tensor, cfg, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     window: int | None = None) -> torch.Tensor:
    """Single-token decode; writes this token's K/V into the caches.

    x1: (B, 1, D); k_cache/v_cache: (B, S, Hkv, hd), updated in place;
    lengths: (B,) int32 valid entries per row. Returns out (B, 1, D).
    """
    B = x1.shape[0]
    q, k, v = _project_qkv(p, x1, cfg)              # q (B,1,Hq,hd)
    pos = lengths.long()
    q = rotary(q, pos[:, None], cfg.rope_theta)
    k = rotary(k, pos[:, None], cfg.rope_theta)

    # write row `pos` of each batch row. The reference's
    # dynamic_update_slice clamps its start index, so a row whose length
    # has reached S (a free batcher slot keeps decoding) writes row S-1.
    S = k_cache.shape[1]
    rows = torch.arange(B, device=x1.device)
    at = pos.clamp(0, S - 1)
    k_cache[rows, at] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, at] = v[:, 0].to(v_cache.dtype)

    out = ops.decode_attention(q[:, 0], k_cache, v_cache, lengths + 1,
                               window=window)
    out = out.reshape(B, 1, cfg.n_heads * cfg.resolved_head_dim)
    return out @ p["wo"].to(x1.dtype)
