"""Plain float32 reference of the port's ``dense`` family: pre-norm
blocks of grouped-query attention (rotary embeddings on NeoX halves, a
bias on q, k and v where ``qkv_bias``) and a gated MLP, from token ids to
logits, as the port's configuration defines them. No kernel, cache or
batching. ``shapes`` gives the leaves it reads, which ``weights`` makes.

Per block, for h (B, S, D):
  x = rmsnorm(h) (1 + w_ln1);  q, k, v = x W_q + b_q, x W_k + b_k, x W_v + b_v
  q, k rotated by position;  query head j reads key head j // (Hq / Hkv)
  h = h + softmax(q k^T / sqrt(hd), causal) v W_o
  x = rmsnorm(h) (1 + w_ln2);  h = h + (act(x W_gate) * x W_up) W_down

Imports torch and the references beside it only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.layers import F32, matmul, rmsnorm


def _sizes(cfg: dict) -> tuple:
    hq, hkv = cfg["n_heads"], cfg["n_kv_heads"]
    return hq, hkv, cfg.get("head_dim") or cfg["d_model"] // hq


def shapes(cfg: dict) -> dict:
    """{path: (shape, kind)} of every leaf of the ``dense`` family, in the
    program's tree order (kinds as ``weights`` makes them)."""
    L, D, V, Fw = (cfg["n_layers"], cfg["d_model"], cfg["vocab_size"],
                   cfg["d_ff"])
    hq, hkv, hd = _sizes(cfg)
    out = {
        "embed.tok": ((V, D), ("normal", D)),
        "layers.ln1": ((L, D), ("norm",)),
        "layers.attn.wq": ((L, D, hq * hd), ("normal", D)),
        "layers.attn.wk": ((L, D, hkv * hd), ("normal", D)),
        "layers.attn.wv": ((L, D, hkv * hd), ("normal", D)),
        "layers.attn.wo": ((L, hq * hd, D), ("normal", hq * hd)),
    }
    if cfg["qkv_bias"]:
        out["layers.attn.bq"] = ((L, hq * hd), ("norm",))
        out["layers.attn.bk"] = ((L, hkv * hd), ("norm",))
        out["layers.attn.bv"] = ((L, hkv * hd), ("norm",))
    out["layers.ln2"] = ((L, D), ("norm",))
    out["layers.mlp.w_up"] = ((L, D, Fw), ("normal", D))
    out["layers.mlp.w_down"] = ((L, Fw, D), ("normal", Fw))
    out["layers.mlp.w_gate"] = ((L, D, Fw), ("normal", D))
    out["final_norm"] = ((D,), ("norm",))
    if not cfg["tie_embeddings"]:
        out["lm_head"] = ((D, V), ("normal", D))
    return out


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) rotated by its position: the first half of each
    head against the second."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = (torch.arange(S, dtype=torch.float64)[:, None] * freq)
    sin = torch.sin(ang).to(F32).to(x.device)[None, :, None, :]
    cos = torch.cos(ang).to(F32).to(x.device)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, x: torch.Tensor, cfg: dict, precision: str):
    """One attention block's output for its normed input x (B, S, D)."""
    B, S, _ = x.shape
    hq, hkv, hd = _sizes(cfg)
    q, k, v = (matmul(x, p[w], precision) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rotary(q.reshape(B, S, hq, hd), cfg["rope_theta"])
    k = rotary(k.reshape(B, S, hkv, hd), cfg["rope_theta"])
    k = k.repeat_interleave(hq // hkv, dim=2)
    v = v.reshape(B, S, hkv, hd).repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    future = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    a = torch.softmax(scores.masked_fill(future, -torch.inf), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, hq * hd)
    return matmul(o, p["wo"], precision)


def mlp(p: dict, x: torch.Tensor, cfg: dict, precision: str):
    act = {"silu": F.silu,
           "gelu": lambda t: F.gelu(t, approximate="tanh")}[
        cfg["activation"]]
    h = act(matmul(x, p["w_gate"], precision)) \
        * matmul(x, p["w_up"], precision)
    return matmul(h, p["w_down"], precision)


def logits(params: dict, cfg: dict, tokens: torch.Tensor, *,
           rows: slice | None = None,
           precision: str = "fp32") -> torch.Tensor:
    """Float32 logits (B, S, V) of tokens (B, S), or of positions ``rows``
    only."""
    eps = cfg["norm_eps"]
    lay = params["layers"]
    h = params["embed"]["tok"].to(F32)[tokens.long()]
    for i in range(cfg["n_layers"]):
        at = {k: v[i].to(F32) for k, v in lay["attn"].items()}
        ml = {k: v[i].to(F32) for k, v in lay["mlp"].items()}
        h = h + attention(at, rmsnorm(h, lay["ln1"][i].to(F32), eps), cfg,
                          precision)
        h = h + mlp(ml, rmsnorm(h, lay["ln2"][i].to(F32), eps), cfg,
                    precision)
    if rows is not None:
        h = h[:, rows]
    h = rmsnorm(h, params["final_norm"].to(F32), eps)
    head = (params["embed"]["tok"].to(F32).T if cfg["tie_embeddings"]
            else params["lm_head"].to(F32))
    return matmul(h, head, precision)
