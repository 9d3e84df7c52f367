"""A plain float32 model of the published Zamba2 block (Zamba2-7B-Instruct's
layout at any width), written from transformers' ``modeling_zamba2.py``,
for the port's tests: the full forward of one sequence, no cache, no
batching, no port kernel and no JAX. It runs on the CPU or on a card
(TF32 off for the products while it runs).

Per layer i of ``n_layers``, with emb the token embeddings and h the
hidden state (``Zamba2HybridLayer``, ``Zamba2MambaDecoderLayer``):
  if i is the j-th of ``hybrid_layer_ids``, block b = j mod num_mem_blocks:
    x = rmsnorm_b1(cat(h, emb))                       (2 d_model wide)
    a = softmax(q k^T (hd / 2)^-1/2, causal) v W_o    (rotary on q, k)
    n = rmsnorm_b2(a)                                 (no residual)
    t = ((gelu(n W_gate + lo_g) * (n W_up + lo_u)) W_down) W_linear[j]
        with [lo_g ; lo_u] = (n A_j) B_j, invocation j's adapter
    h_in = h + t
  else h_in = h
  h = h + Mamba_i(rmsnorm_i(h_in))
and the logits rmsnorm(h) E^T (the head tied to the embedding E).
Mamba2 with G B/C groups (head k reads group k // (H / G)), the SSD
recurrence run position by position, and the gated norm over each of the
G groups of d_inner / G channels (``Zamba2RMSNormGated``).

Departures from transformers' code, on purpose:
  - every norm weight is stored as w and applied as (1 + w), the port's
    convention (transformers stores the factor itself);
  - one sequence with no padding mask (transformers takes a batch and an
    attention mask);
  - the SSD scan is the plain recurrence, where transformers computes it
    chunked; the two are the same sum.

``ablate`` names parts to leave out, so a test can show its tolerance
would see each one missing: ``adapter``, ``linear``, ``concat`` (zeros in
place of the embeddings), ``scale`` (hd^-1/2), ``group_norm`` (one norm
over all of d_inner), ``second_group`` (every head reads group 0),
``exact_gelu`` (the tanh GELU).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

F32 = torch.float32
ABLATIONS = ("adapter", "linear", "concat", "scale", "group_norm",
             "second_group", "exact_gelu")


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + w)


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rotary(x, theta):
    """x (S, H, hd): transformers' ``apply_rotary_pos_emb`` at positions
    0..S-1 over all hd dims."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32,
                                       device=x.device) / hd)
    freqs = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, :]
    return x * emb.cos() + rotate_half(x) * emb.sin()


def attention(p, x, cfg, ablate, block_rows=1024):
    """Causal attention of x (S, 2D) -> (S, D), computed in blocks of
    query rows."""
    S = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = rotary((x @ p["wq"]).reshape(S, hq, hd), cfg.rope_theta)
    k = rotary((x @ p["wk"]).reshape(S, hkv, hd), cfg.rope_theta)
    v = (x @ p["wv"]).reshape(S, hkv, hd)
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    scale = hd ** -0.5 if "scale" in ablate else (hd / 2) ** -0.5
    out = []
    for r0 in range(0, S, block_rows):
        r1 = min(S, r0 + block_rows)
        s = torch.einsum("qhd,khd->hqk", q[r0:r1], k[:r1]) * scale
        mask = torch.arange(r1, device=x.device)[None, :] > \
            torch.arange(r0, r1, device=x.device)[:, None]
        s = s.masked_fill(mask[None], float("-inf"))
        out.append(torch.einsum("hqk,khd->qhd", s.softmax(-1), v[:r1]))
    return torch.cat(out).reshape(S, hq * hd) @ p["wo"]


def shared_block(params, cfg, j, h, emb, ablate):
    """Invocation j of the shared blocks -> t (S, D)."""
    b = j % cfg.num_mem_blocks
    blk = {k: v[b] for k, v in params["shared"].items()
           if not isinstance(v, dict)}
    attn_p = {k: v[b] for k, v in params["shared"]["attn"].items()}
    mlp_p = {k: v[b] for k, v in params["shared"]["mlp"].items()}
    hy = params["hybrid"]
    other = torch.zeros_like(emb) if "concat" in ablate else emb
    x = rmsnorm(torch.cat([h, other], dim=-1), blk["ln1"], cfg.norm_eps)
    a = attention(attn_p, x, cfg, ablate)
    n = rmsnorm(a, blk["ln2"], cfg.norm_eps)
    f = cfg.d_ff
    gate, up = n @ mlp_p["w_gate"], n @ mlp_p["w_up"]
    if "adapter" not in ablate:
        lo = (n @ hy["adapter_down"][j]) @ hy["adapter_up"][j]
        gate, up = gate + lo[:, :f], up + lo[:, f:]
    act = F.gelu(gate, approximate="tanh") if "exact_gelu" in ablate \
        else F.gelu(gate)
    m = (act * up) @ mlp_p["w_down"]
    return m if "linear" in ablate else m @ hy["linear"][j]


def mamba(p, x, cfg, ablate):
    """One Mamba2 mixer on its normed input x (S, D) -> (S, D)."""
    S = x.shape[0]
    din, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    H, P, k = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv
    z, xbc, dt = (x @ p["in_proj"]).split([din, din + 2 * G * N, H], dim=-1)
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    xbc = F.silu(sum(pad[i:i + S] * p["conv_w"][i] for i in range(k))
                 + p["conv_b"])
    xs, Bm, Cm = xbc.split([din, G * N, G * N], dim=-1)
    Bm, Cm = Bm.reshape(S, G, N), Cm.reshape(S, G, N)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xs = xs.reshape(S, H, P)
    group = torch.arange(H, device=x.device) // (H // G)
    if "second_group" in ablate:
        group = torch.zeros_like(group)
    state = torch.zeros(H, P, N, dtype=F32, device=x.device)
    ys = []
    for t in range(S):
        Bt, Ct = Bm[t][group], Cm[t][group]                 # (H, N)
        state = state * torch.exp(dt[t] * A)[:, None, None] \
            + (dt[t][:, None] * xs[t])[:, :, None] * Bt[:, None, :]
        ys.append(torch.einsum("hpn,hn->hp", state, Ct))
    y = torch.stack(ys) + p["D"][:, None] * xs
    g = y.reshape(S, din) * F.silu(z)
    groups = 1 if "group_norm" in ablate else G
    g = g.reshape(S, groups, din // groups)
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + cfg.norm_eps)
    return (g.reshape(S, din) * (1 + p["norm"])) @ p["out_proj"]


def logits(params, cfg, tokens, ablate=()) -> torch.Tensor:
    """Float32 logits (S, V) of one sequence of token ids (S,)."""
    unknown = set(ablate) - set(ABLATIONS)
    if unknown:
        raise ValueError(f"unknown ablations {sorted(unknown)}")
    params = torch.utils._pytree.tree_map(lambda t: t.to(F32), params)
    with no_tf32():
        emb = params["embed"]["tok"][tokens.long()]
        h = emb
        calls = {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}
        lay = params["layers"]
        for i in range(cfg.n_layers):
            x = h
            if i in calls:
                x = h + shared_block(params, cfg, calls[i], h, emb, ablate)
            p = {k: v[i] for k, v in lay["ssm"].items()}
            h = h + mamba(p, rmsnorm(x, lay["ln1"][i], cfg.norm_eps), cfg,
                          ablate)
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return h @ params["embed"]["tok"].T
