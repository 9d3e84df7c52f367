"""Mixture-of-Experts layer: top-k routing, sort-based equal-capacity
dispatch, load-balance aux loss.

Dispatch is *sort-based*, as in the reference: tokens are routed within
fixed-size groups, argsorted (stably) by expert id, gathered into a
(G, E, C, D) slot layout, processed by a batched per-expert product
(active FLOPs only, times the capacity factor), and combined back.

Two choices keep the card's results deterministic where the reference's
ops carry no such promise on CUDA:
- top-k is a stable descending sort (``top_k``), so equal probabilities
  put the lower expert id first, as ``jax.lax.top_k`` does;
- the combine is a gather, not a float scatter-add (``index_add_`` sums
  with atomics in no fixed order): each (token, choice) reads the slot it
  landed in, or a zero row if it was dropped at capacity, and the token
  sums its choices in ascending expert id, the order in which the
  reference's sorted slots are added.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.launch.sharding import shard
from repro_torch.models.layers import dense_init
from repro_torch.models.mlp import _act, is_gated

_GROUP_TOKENS = 2048  # routing group size (sort locality; multiple of DP shards)


def init_moe(gen: torch.Generator, cfg, stack: int | None = None,
             dtype=torch.float32, device=None):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    lead = (stack,) if stack else ()
    kw = dict(dtype=dtype, device=device)
    p = {"router": dense_init(gen, lead + (d, E), **kw),
         "w_up": dense_init(gen, lead + (E, d, f), **kw),
         "w_down": dense_init(gen, lead + (E, f, d), **kw)}
    if is_gated(cfg.activation):
        p["w_gate"] = dense_init(gen, lead + (E, d, f), **kw)
    return p


def n_route_groups(n_tokens: int, kind: str, batch: int) -> int:
    if kind == "decode" or n_tokens <= _GROUP_TOKENS:
        return max(1, batch if kind == "decode" else 1)
    assert n_tokens % _GROUP_TOKENS == 0, (n_tokens, _GROUP_TOKENS)
    return n_tokens // _GROUP_TOKENS


def _capacity(group_tokens: int, cfg) -> int:
    m = cfg.moe
    cap = int(group_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(1, -(-cap // 4) * 4) if group_tokens > 64 else max(4, cap)


class Routing(NamedTuple):
    """Where a group's tokens go. ``E*C`` is the sentinel slot of a choice
    dropped at capacity; ``Tg`` the sentinel token of an empty slot."""
    gate_idx: torch.Tensor    # (G, Tg, K) expert of each choice, top first
    aux: torch.Tensor         # fp32 scalar, the Switch load-balance loss
    slot_tok: torch.Tensor    # (G, E*C) source token of each slot
    slot_gate: torch.Tensor   # (G, E*C) fp32 gate of each slot, 0 if empty
    choice_slot: torch.Tensor  # (G, Tg, K) slot of each choice, E*C if dropped


def top_k(probs: torch.Tensor, K: int) -> tuple:
    """(values, indices) of the K largest probabilities, largest first;
    equal values put the lower index first, as ``jax.lax.top_k`` does (a
    stable descending sort: ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def route(p, xg: torch.Tensor, cfg, C: int) -> Routing:
    """Routing of xg (G, Tg, D) at capacity C per expert and group."""
    G, Tg, _ = xg.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    dev = xg.device
    # --- routing (fp32) ---
    logits = torch.einsum("gtd,de->gte", xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)                       # (G, Tg, E)
    gate_vals, gate_idx = top_k(probs, K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # --- Switch-style load-balance aux loss ---
    me = probs.mean(dim=(0, 1))                                 # (E,)
    # an iota compare, not F.one_hot: on the CPU one_hot reads the
    # indices' range on the host, which the CPU test of the decode-step
    # capture (tests/test_torch_decode_graph.py) traps as a CUDA capture
    # would; on the card one_hot reads nothing there. Same 0/1 values.
    ce = (gate_idx[..., 0, None] == torch.arange(E, device=dev)
          ).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    # --- sort slots by expert id within each group ---
    Sk = Tg * K
    eflat = gate_idx.reshape(G, Sk)                             # expert per slot
    gflat = gate_vals.reshape(G, Sk)
    order = torch.argsort(eflat, dim=-1, stable=True)           # (G, Sk)
    e_sorted = eflat.gather(-1, order)
    g_sorted = gflat.gather(-1, order)
    tok_sorted = order // K                                     # source token

    counts = (eflat[..., None] == torch.arange(E, device=dev)).sum(dim=1)
    starts = counts.cumsum(dim=-1) - counts                     # (G, E)
    pos_in_e = torch.arange(Sk, device=dev)[None, :] - starts.gather(
        -1, e_sorted)                                           # (G, Sk)
    keep = pos_in_e < C
    dest = torch.where(keep, e_sorted * C + pos_in_e, E * C)    # sentinel slot

    # --- slot -> token index and slot gate; only the discarded sentinel
    # cell receives more than one write (the buffers are made like
    # ``dest``, so a DTensor routing scatters into a DTensor) ---
    slot_tok = dest.new_full((G, E * C + 1), Tg, dtype=order.dtype
                             ).scatter_(-1, dest, tok_sorted)
    slot_gate = dest.new_zeros((G, E * C + 1), dtype=torch.float32
                               ).scatter_(
        -1, dest, torch.where(keep, g_sorted, 0.0))
    # each choice's slot, back in (token, choice) order: order is a
    # permutation, so this scatter writes every cell once
    choice_slot = torch.empty_like(dest).scatter_(-1, order, dest)
    return Routing(gate_idx, aux, slot_tok[:, :E * C], slot_gate[:, :E * C],
                   choice_slot.view(G, Tg, K))


def apply_moe(p, x: torch.Tensor, cfg, n_groups: int = 1):
    """x: (B, S, D) -> (out (B, S, D), aux_loss fp32 scalar)."""
    B, S, D = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    dt = x.dtype
    T = B * S
    G = n_groups
    assert T % G == 0, (T, G)
    Tg = T // G
    C = _capacity(Tg, cfg)
    xg = shard(x.reshape(G, Tg, D), "batch", None, None)
    r = route(p, xg, cfg, C)

    # --- gather tokens into (G, E, C, D) slots (sentinel row = zeros) ---
    x_pad = torch.cat([xg, xg.new_zeros(G, 1, D)], dim=1)
    ex_in = x_pad.gather(1, r.slot_tok[..., None].expand(-1, -1, D))
    ex_in = shard(ex_in.view(G, E, C, D), "batch", "experts", None, None)

    # --- batched per-expert FFN (active FLOPs only) ---
    up = torch.einsum("gecd,edf->gecf", ex_in, p["w_up"].to(dt))
    if is_gated(cfg.activation):
        g = torch.einsum("gecd,edf->gecf", ex_in, p["w_gate"].to(dt))
        h = _act(g, cfg.activation) * up
    else:
        h = _act(up, cfg.activation)
    ex_out = shard(torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt)),
                   "batch", "experts", None, None)

    # --- combine: each choice gathers its gated slot (a dropped one the
    # zero sentinel row), summed in ascending expert id ---
    gated = ex_out.reshape(G, E * C, D) * r.slot_gate[..., None].to(dt)
    gated = torch.cat([gated, gated.new_zeros(G, 1, D)], dim=1)
    slots = r.choice_slot.gather(-1, torch.argsort(r.gate_idx, dim=-1))
    vals = gated.gather(1, slots.reshape(G, Tg * K, 1).expand(-1, -1, D))
    vals = vals.view(G, Tg, K, D)
    out = vals[:, :, 0]
    for k in range(1, K):
        out = out + vals[:, :, k]
    return shard(out.reshape(B, S, D), "batch", None, None), r.aux
