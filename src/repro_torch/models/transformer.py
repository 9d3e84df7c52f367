"""Model assembly for the dense family (attention + FFN blocks).

Parameters keep the reference's pytree: nested dicts whose per-layer
leaves are stacked on a leading L axis. The layers run in a Python loop
over views ``leaf[i]``, so each layer's window is a Python int that the
kernels take as a static argument.

Two serving entry points: ``prefill`` (build the KV cache, last-token
logits) and ``decode_step`` (one token against the cache). ``decode_step``
updates the cache in place — the port's counterpart of the reference's
buffer donation — and returns the same dict.

Only the dense family is ported; the others raise NotImplementedError.
"""
from __future__ import annotations

import torch

from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import GLOBAL_WINDOW
from repro_torch.models.layers import dense_init, embed_lookup, rmsnorm


def _require_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"repro_torch ports the dense family "
                                  f"only; {cfg.name} is {cfg.family}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg, dtype=torch.float32):
    """Random weights drawn from ``gen`` on its device. Each leaf is drawn
    in fp32 and cast to ``dtype`` at once, so a full-width bf16 init never
    holds the whole fp32 model."""
    _require_dense(cfg)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    dev = gen.device
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    params = {"embed": {"tok": dense_init(gen, (V, D), in_axis=-1,
                                          dtype=dtype)}}
    params["layers"] = {
        "ln1": zeros(L, D),
        "attn": attn.init_attention(gen, cfg, stack=L, dtype=dtype),
        "ln2": zeros(L, D),
        "mlp": mlp_mod.init_mlp(gen, cfg, stack=L, dtype=dtype),
    }
    params["final_norm"] = zeros(D)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (D, V), dtype=dtype)
    return params


def layer_windows(cfg) -> list:
    """Per-layer attention window as Python ints; GLOBAL_WINDOW = full."""
    L = cfg.n_layers
    if cfg.sliding_window is None:
        return [GLOBAL_WINDOW] * L
    every = cfg.global_every or L + 1
    return [GLOBAL_WINDOW if (i + 1) % every == 0 else cfg.sliding_window
            for i in range(L)]


def _layer(tree, i: int):
    """Layer ``i`` of the stacked per-layer params, as views."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _embed(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return embed_lookup(params["embed"]["tok"], tokens, torch_dtype(cfg.dtype))


def _unembed(params, cfg, h: torch.Tensor) -> torch.Tensor:
    dt = h.dtype
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ params["embed"]["tok"].to(dt).T
    return h @ params["lm_head"].to(dt)


def _ffn(p_l, hn: torch.Tensor, cfg) -> torch.Tensor:
    return mlp_mod.apply_mlp(p_l["mlp"], hn, cfg)


# ---------------------------------------------------------------------------
# prefill: build the cache, return last-token logits
# ---------------------------------------------------------------------------
def prefill(params, cfg, tokens: torch.Tensor):
    """tokens (B,S) -> (logits (B,V), cache {k, v: (L,B,S,Hkv,hd), length})."""
    _require_dense(cfg)
    h = _embed(params, cfg, tokens)
    B, S, _ = h.shape
    dt = h.dtype
    positions = torch.arange(S, device=h.device)[None, :]
    ks, vs = [], []
    for i, window in enumerate(layer_windows(cfg)):
        p_l = _layer(params["layers"], i)
        hn = rmsnorm(h, p_l["ln1"], cfg.norm_eps)
        a, (k, v) = attn.attention_prefill(p_l["attn"], hn, cfg, positions,
                                           window)
        h = h + a
        hn = rmsnorm(h, p_l["ln2"], cfg.norm_eps)
        h = h + _ffn(p_l, hn, cfg)
        ks.append(k.to(dt))
        vs.append(v.to(dt))
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "length": torch.full((B,), S, dtype=torch.int32,
                                  device=h.device)}
    return _unembed(params, cfg, h[:, -1:, :])[:, 0], cache


# ---------------------------------------------------------------------------
# decode: one token against the cache, in place
# ---------------------------------------------------------------------------
def decode_step(params, cfg, cache, tokens: torch.Tensor):
    """tokens (B,1) -> (logits (B,V), cache). Writes each layer's new K/V
    row into ``cache["k"]``/``cache["v"]`` and bumps ``cache["length"]``,
    all in place."""
    _require_dense(cfg)
    h = _embed(params, cfg, tokens)
    lengths = cache["length"]
    for i, window in enumerate(layer_windows(cfg)):
        p_l = _layer(params["layers"], i)
        hn = rmsnorm(h, p_l["ln1"], cfg.norm_eps)
        h = h + attn.attention_decode(p_l["attn"], hn, cfg, cache["k"][i],
                                      cache["v"][i], lengths, window)
        hn = rmsnorm(h, p_l["ln2"], cfg.norm_eps)
        h = h + _ffn(p_l, hn, cfg)
    lengths.add_(1)
    return _unembed(params, cfg, h)[:, 0], cache
