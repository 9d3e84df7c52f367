"""Model flops of the ``hybrid`` family as published by Zamba2
(``hybrid_layer_ids``), from a configuration's sizes: 2 flops a
multiply-add of every weight a token passes through, plus the products of
attention and of the SSD scan.

  - the Mamba2 layers: in_proj, the conv taps, out_proj (B/C in
    ``ssm_groups`` groups);
  - each of the ``hybrid_layer_ids`` invocations: its shared block's q,
    k, v (from [hidden ; embeddings], 2 d_model wide) and output
    projections and gated MLP, its own rank-``adapter_rank`` adapter and
    its own d_model x d_model linear (the blocks run once per invocation,
    so a token passes through them 13 times at the published sizes);
  - attention: q k^T and the weighted sum of v, 4 hd flops a query head
    for each key its position sees (causal in a prefill, ``ctx`` keys in
    a decode), in each invocation;
  - the scan: ``counts/ssd_scan`` with the configuration's groups, a
    layer; in a decode the state update and read, 4 H P N a layer;
  - the tied head where logits are taken; not the embedding, a lookup.

  attention_calls(cfg): attention calls a token's forward makes, one an
      invocation (the attention rooflines' count)
  applied_params(cfg): weights one token passes through in the body
  prefill(cfg, S): one prompt of S positions, logits of the last one
  decode(cfg, ctx): one generated token whose position sees ``ctx`` keys
"""
from __future__ import annotations

from portbench.counts import ssd_scan


def _sizes(cfg: dict) -> dict:
    D = cfg["d_model"]
    din = cfg["ssm_expand"] * D
    return dict(D=D, din=din, G=cfg["ssm_groups"], N=cfg["ssm_state"],
                P=cfg["ssm_head_dim"], H=din // cfg["ssm_head_dim"])


def mamba_params(cfg: dict) -> int:
    """Weights a token passes through in one Mamba2 layer."""
    s = _sizes(cfg)
    D, din, G, N, H = s["D"], s["din"], s["G"], s["N"], s["H"]
    cd = din + 2 * G * N
    return D * (din + cd + H) + cfg["ssm_conv"] * cd + din * D


def invocation_params(cfg: dict) -> int:
    """Weights a token passes through in one invocation of a shared
    block: the block, the invocation's adapter and its linear."""
    D, Fw, r = cfg["d_model"], cfg["d_ff"], cfg["adapter_rank"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    attn = 2 * D * (hq + 2 * hkv) * hd + hq * hd * D
    return attn + 3 * D * Fw + r * (D + 2 * Fw) + D * D


def applied_params(cfg: dict) -> int:
    return cfg["n_layers"] * mamba_params(cfg) \
        + attention_calls(cfg) * invocation_params(cfg)


def head_params(cfg: dict) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def attention_calls(cfg: dict) -> int:
    return len(cfg["hybrid_layer_ids"])


def _attention(cfg: dict, keys: int) -> float:
    """Every invocation's q k^T and p v over ``keys`` (query, key) pairs."""
    return 4.0 * attention_calls(cfg) * cfg["n_heads"] * cfg["head_dim"] \
        * keys


def prefill(cfg: dict, S: int) -> float:
    s = _sizes(cfg)
    chunk = min(cfg["ssm_chunk"], S)
    scan = ssd_scan.cost(1, S, s["H"], s["P"], s["N"], chunk,
                         groups=s["G"])[1] * cfg["n_layers"]
    return (2.0 * applied_params(cfg) * S + 2.0 * head_params(cfg) + scan
            + _attention(cfg, S * (S + 1) // 2))


def decode(cfg: dict, ctx: int) -> float:
    s = _sizes(cfg)
    scan = 4.0 * s["H"] * s["P"] * s["N"] * cfg["n_layers"]
    return 2.0 * (applied_params(cfg) + head_params(cfg)) + scan \
        + _attention(cfg, ctx)
