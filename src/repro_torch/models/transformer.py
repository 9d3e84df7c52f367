"""Model assembly for all the families.

dense / moe / vlm / audio -> attention + FFN blocks (moe: the FFN is the
                             routed experts of ``models/moe``)
ssm                       -> Mamba2 (SSD) blocks
hybrid                    -> (zamba2) Mamba2 backbone + ONE shared
                             attention+FFN block applied after every
                             ``hybrid_attn_every`` Mamba layers

The vlm family puts its prefix embeddings (a stubbed vision tower's
``frontend_tokens`` positions) before the token embeddings when they are
given; the audio family takes frame embeddings in place of tokens, has no
embedding table and always an ``lm_head``.

Parameters keep the reference's pytree: nested dicts whose per-layer
leaves are stacked on a leading L axis. The layers run in a Python loop
over views ``leaf[i]``, so each layer's window is a Python int that the
kernels take as a static argument.

Three entry points, as in the reference: ``forward`` (training: the
whole sequence, no cache, logits and the MoE aux loss), ``prefill``
(build the KV cache, last-token logits) and ``decode_step`` (one token
against the cache). ``decode_step`` updates the cache in place — the
port's counterpart of the reference's buffer donation — and returns the
same dict.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tracing import step_span
from repro_torch.device import torch_dtype
from repro_torch.launch.sharding import shard
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import GLOBAL_WINDOW
from repro_torch.models.layers import dense_init, embed_lookup, rmsnorm


def hybrid_groups(cfg) -> int:
    """Applications of the shared block: one after every k Mamba layers."""
    k = cfg.hybrid_attn_every
    if cfg.n_layers % k:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into groups of hybrid_attn_every={k}")
    return cfg.n_layers // k


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg, dtype=torch.float32,
                device=None):
    """Random weights drawn from ``gen`` on its device (or on ``device``:
    ``meta`` from a CPU generator gives the tree with no data). Each leaf
    is drawn in fp32 and cast to ``dtype`` at once, so a full-width bf16
    init never holds the whole fp32 model."""
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    dev = gen.device if device is None else device
    kw = dict(dtype=dtype, device=dev)
    zeros = lambda *shape: torch.zeros(shape, **kw)
    params = {}
    if cfg.family != "audio":
        params["embed"] = {"tok": dense_init(gen, (V, D), in_axis=-1, **kw)}
    if cfg.family in ("ssm", "hybrid"):
        params["layers"] = {"ln1": zeros(L, D),
                            "ssm": ssm_mod.init_mamba(gen, cfg, stack=L,
                                                      **kw)}
    else:
        params["layers"] = {
            "ln1": zeros(L, D),
            "attn": attn.init_attention(gen, cfg, stack=L, **kw),
            "ln2": zeros(L, D),
        }
        if cfg.moe is not None:
            params["layers"]["moe"] = moe_mod.init_moe(gen, cfg, stack=L,
                                                       **kw)
        else:
            params["layers"]["mlp"] = mlp_mod.init_mlp(gen, cfg, stack=L,
                                                       **kw)
    if cfg.family == "hybrid":
        params["shared"] = {
            "ln1": zeros(D),
            "attn": attn.init_attention(gen, cfg, **kw),
            "ln2": zeros(D),
            "mlp": mlp_mod.init_mlp(gen, cfg, **kw),
        }
    params["final_norm"] = zeros(D)
    if not cfg.tie_embeddings or cfg.family == "audio":
        params["lm_head"] = dense_init(gen, (D, V), **kw)
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


def _embed(params, cfg, tokens, embeds) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "audio":
        return embeds.to(dt)
    h = embed_lookup(params["embed"]["tok"], tokens, dt)
    if cfg.family == "vlm" and embeds is not None:
        h = torch.cat([embeds.to(dt), h], dim=1)
    return h


def _unembed(params, cfg, h: torch.Tensor) -> torch.Tensor:
    dt = h.dtype
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["tok"].to(dt).T
    else:
        logits = h @ params["lm_head"].to(dt)
    return shard(logits, "batch", None, "vocab")


def _ffn(p_l, hn: torch.Tensor, cfg, n_groups: int) -> tuple:
    """-> (out, MoE aux loss or 0.0). The aux loss is for training; the
    serving paths drop it, as the reference's prefill and decode do."""
    if "moe" in p_l:
        return moe_mod.apply_moe(p_l["moe"], hn, cfg, n_groups)
    return mlp_mod.apply_mlp(p_l["mlp"], hn, cfg), 0.0


def _attn_ffn_prefill(p_l, h: torch.Tensor, cfg, positions, window,
                      n_groups: int = 1):
    """One attention + FFN block (a layer, or the hybrid's shared block)
    over the whole sequence -> (h, (k, v), aux)."""
    with step_span("norm"):
        hn = rmsnorm(h, p_l["ln1"], cfg.norm_eps)
    with step_span("mixer"):
        a, kv = attn.attention_prefill(p_l["attn"], hn, cfg, positions,
                                       window)
        h = h + a
    with step_span("norm"):
        hn = rmsnorm(h, p_l["ln2"], cfg.norm_eps)
    with step_span("ffn"):
        out, aux = _ffn(p_l, hn, cfg, n_groups)
        return h + out, kv, aux


def _attn_ffn_decode(p_l, h: torch.Tensor, cfg, k_cache, v_cache, lengths,
                     window, n_groups: int = 1) -> torch.Tensor:
    with step_span("norm"):
        hn = rmsnorm(h, p_l["ln1"], cfg.norm_eps)
    with step_span("mixer"):
        h = h + attn.attention_decode(p_l["attn"], hn, cfg, k_cache,
                                      v_cache, lengths, window)
    with step_span("norm"):
        hn = rmsnorm(h, p_l["ln2"], cfg.norm_eps)
    with step_span("ffn"):
        return h + _ffn(p_l, hn, cfg, n_groups)[0]


def _shared_after(cfg, i: int) -> bool:
    """Whether the hybrid's shared block follows Mamba layer ``i``."""
    return cfg.family == "hybrid" and (i + 1) % cfg.hybrid_attn_every == 0


# ---------------------------------------------------------------------------
# train forward (no cache)
# ---------------------------------------------------------------------------
def _save_dots():
    """Selective-checkpoint contexts that save the matmul outputs and
    recompute the rest: the counterpart of JAX's ``checkpoint_dots``."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    aten = torch.ops.aten
    dots = {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _remat_wrap(body, remat):
    """``body`` recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``) when ``remat`` is set; ``"dots"`` keeps
    the matmul outputs and recomputes the rest, as the reference's
    ``checkpoint_dots`` policy does."""
    if not remat:
        return body
    if remat == "dots":
        return lambda *args: checkpoint(body, *args, use_reentrant=False,
                                        context_fn=_save_dots)
    return lambda *args: checkpoint(body, *args, use_reentrant=False)


def forward(params, cfg, tokens=None, embeds=None, *, remat=False,
            n_groups: int = 1):
    """The whole sequence, no cache -> (logits (B,S,V) in cfg.dtype, aux
    fp32 scalar: the MoE load-balance loss summed over layers, 0 for the
    other families). ``remat`` recomputes each layer body (the hybrid:
    each group of Mamba layers with its shared block) in the backward."""
    h = shard(_embed(params, cfg, tokens, embeds), "batch", None, None)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def mamba(h, p_l):
        hn = rmsnorm(h, p_l["ln1"], cfg.norm_eps)
        return h + ssm_mod.mamba_prefill(p_l["ssm"], hn, cfg)[0]

    if cfg.family == "ssm":
        body = _remat_wrap(mamba, remat)
        for i in range(cfg.n_layers):
            h = body(h, _layer(params["layers"], i))
        return _unembed(params, cfg, h), aux

    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every

        def group(h, pg, shared):
            for p_l in pg:
                h = mamba(h, p_l)
            return _attn_ffn_prefill(shared, h, cfg, positions, None)[0]
        body = _remat_wrap(group, remat)
        for g in range(hybrid_groups(cfg)):
            pg = [_layer(params["layers"], i) for i in range(g * k, g * k + k)]
            h = body(h, pg, params["shared"])
        return _unembed(params, cfg, h), aux

    def layer(h, p_l, window):
        h, _, a = _attn_ffn_prefill(p_l, h, cfg, positions, window, n_groups)
        return h, a

    body = _remat_wrap(layer, remat)
    for i, window in enumerate(layer_windows(cfg)):
        h, a = body(h, _layer(params["layers"], i), window)
        aux = aux + a
    return _unembed(params, cfg, h), aux


# ---------------------------------------------------------------------------
# prefill: build the cache, return last-token logits
# ---------------------------------------------------------------------------
def prefill(params, cfg, tokens=None, embeds=None, *, n_groups: int = 1):
    """tokens (B,S) and/or embeds (B,F,D) -> (logits (B,V), cache). S
    counts the whole sequence, a vlm prefix included. The cache holds,
    by family:
    dense, moe, vlm, audio  {k, v: (L,B,S,Hkv,hd), length};
    ssm     {conv: (L,B,k-1,conv_dim), state: (L,B,H,P,N) fp32, length};
    hybrid  the ssm leaves plus {k, v: (G,B,S,Hkv,hd)}, G = L // k."""
    with step_span("embed"):
        h = shard(_embed(params, cfg, tokens, embeds), "batch", None, None)
    B, S, _ = h.shape
    dt = h.dtype
    positions = torch.arange(S, device=h.device)[None, :]
    cache, ks, vs = {}, [], []
    if cfg.family not in ("ssm", "hybrid"):
        for i, window in enumerate(layer_windows(cfg)):
            h, (k, v), _ = _attn_ffn_prefill(_layer(params["layers"], i),
                                             h, cfg, positions, window,
                                             n_groups)
            ks.append(k.to(dt))
            vs.append(v.to(dt))
    else:
        convs, states = [], []
        for i in range(cfg.n_layers):
            p_l = _layer(params["layers"], i)
            with step_span("norm"):
                hn = rmsnorm(h, p_l["ln1"], cfg.norm_eps)
            with step_span("mixer"):
                o, (conv, state) = ssm_mod.mamba_prefill(
                    p_l["ssm"], hn, cfg, return_state=True)
                h = h + o
            convs.append(conv)
            states.append(state)
            if _shared_after(cfg, i):
                h, (k, v), _ = _attn_ffn_prefill(params["shared"], h, cfg,
                                                 positions, None)
                ks.append(k.to(dt))
                vs.append(v.to(dt))
    with step_span("cache_pack"):
        if cfg.family not in ("ssm", "hybrid"):
            cache["k"] = shard(torch.stack(ks), None, "batch", "kv_seq",
                               "kv_heads", None)
            cache["v"] = shard(torch.stack(vs), None, "batch", "kv_seq",
                               "kv_heads", None)
        else:
            cache = {"conv": torch.stack(convs),
                     "state": torch.stack(states)}
            if ks:
                cache["k"], cache["v"] = torch.stack(ks), torch.stack(vs)
        cache["length"] = torch.full((B,), S, dtype=torch.int32,
                                     device=h.device)
    # the last position of B > 1 rows is a strided view; the norm's
    # kernel takes contiguous rows
    with step_span("lm_head"):
        return _unembed(params, cfg, h[:, -1:].contiguous())[:, 0], cache


# ---------------------------------------------------------------------------
# decode: one token against the cache, in place
# ---------------------------------------------------------------------------
def decode_step(params, cfg, cache, tokens=None, embeds=None, *,
                n_groups: int = 1):
    """tokens (B,1) / embeds (B,1,D) -> (logits (B,V), cache). Writes
    every layer's new K/V row, conv window and SSM state into the cache's
    leaves and bumps ``cache["length"]``, all in place."""
    with step_span("embed"):
        h = _embed(params, cfg, tokens, embeds)
    lengths = cache["length"]
    if cfg.family not in ("ssm", "hybrid"):
        for i, window in enumerate(layer_windows(cfg)):
            h = _attn_ffn_decode(_layer(params["layers"], i), h, cfg,
                                 cache["k"][i], cache["v"][i], lengths,
                                 window, n_groups)
    else:
        g = 0
        for i in range(cfg.n_layers):
            p_l = _layer(params["layers"], i)
            with step_span("norm"):
                hn = rmsnorm(h, p_l["ln1"], cfg.norm_eps)
            with step_span("mixer"):
                h = h + ssm_mod.mamba_decode(p_l["ssm"], hn, cfg,
                                             cache["conv"][i],
                                             cache["state"][i])
            if _shared_after(cfg, i):
                h = _attn_ffn_decode(params["shared"], h, cfg, cache["k"][g],
                                     cache["v"][g], lengths, None)
                g += 1
    lengths.add_(1)
    with step_span("lm_head"):
        return _unembed(params, cfg, h)[:, 0], cache
