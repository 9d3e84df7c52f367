"""Model flops of the ``dense`` family, from a configuration's sizes: 2
flops a multiply-add of every weight a token passes through (the q, k, v
and output projections, the gated MLP; the output head where logits are
taken; not the embedding, which is a lookup, nor the biases), plus
attention's products: q k^T and the weighted sum of v, 4 hd flops a
query head for each key its position sees.

  applied_params(cfg): weights one token passes through in the body
  prefill(cfg, S): one prompt of S positions (causal), logits of the last
  decode(cfg, ctx): one generated token whose position sees ``ctx`` keys
"""
from __future__ import annotations


def _heads(cfg: dict) -> tuple:
    hq = cfg["n_heads"]
    return hq, cfg["n_kv_heads"], cfg.get("head_dim") or cfg["d_model"] // hq


def applied_params(cfg: dict) -> int:
    D, Fw = cfg["d_model"], cfg["d_ff"]
    hq, hkv, hd = _heads(cfg)
    attn = D * (hq + 2 * hkv) * hd + hq * hd * D
    return cfg["n_layers"] * (attn + 3 * D * Fw)


def head_params(cfg: dict) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def _attention(cfg: dict, keys: int) -> float:
    hq, _, hd = _heads(cfg)
    return 4.0 * cfg["n_layers"] * hq * hd * keys


def prefill(cfg: dict, S: int) -> float:
    return (2.0 * applied_params(cfg) * S + 2.0 * head_params(cfg)
            + _attention(cfg, S * (S + 1) // 2))


def decode(cfg: dict, ctx: int) -> float:
    return 2.0 * (applied_params(cfg) + head_params(cfg)) \
        + _attention(cfg, ctx)
