"""Plain float32 reference of the ``hybrid`` family as published by Zamba2
(``hybrid_layer_ids``: Zamba2-7B-Instruct's layout, transformers'
``modeling_zamba2.py``), from token ids to logits. No kernel, cache or
batching. ``shapes`` gives the leaves it reads, which ``weights`` makes.

Per layer i, with emb the token embeddings and h the hidden state:
  if i is the j-th hybrid layer (shared block b = j mod num_mem_blocks):
    x = rmsnorm(cat(h, emb)) (1 + w_b1)                  2 d_model wide
    a = softmax(q k^T (hd / 2)^-1/2, causal) v W_o        rotary on q, k
    n = rmsnorm(a) (1 + w_b2)                             no residual
    [g ; u] = n [W_gate ; W_up] + (n A_j) B_j             j's adapter
    t = ((gelu(g) * u) W_down) W_linear[j]                erf GELU
    h_in = h + t
  else h_in = h
  h = h + Mamba_i(rmsnorm(h_in) (1 + w_i))
  logits = rmsnorm(h) (1 + w_f) E^T                       tied head
Mamba2 with G B/C groups (head k reads group k // (H / G)); its scan is
``reference/ssm.py``'s ``ssd`` run on each group's heads, and its gated
norm normalises each group's d_inner / G channels on their own.

Departures from transformers' code: norm weights stored as w and applied
as (1 + w), the port's convention; one sequence with no padding mask.

Every product of a projection goes through ``layers.matmul``, so the fp8
control rounds them; attention's and the scan's products stay float32.
Attention is computed in blocks of query rows, so a 4,000-token sequence
needs no (S, S) scores of every head at once.

Imports torch and the references beside it only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.layers import F32, matmul, rmsnorm
from portbench.reference.ssm import ssd, unembed

QUERY_ROWS = 1024


def _sizes(cfg: dict) -> dict:
    D = cfg["d_model"]
    din = cfg["ssm_expand"] * D
    G, N, P = cfg["ssm_groups"], cfg["ssm_state"], cfg["ssm_head_dim"]
    return dict(D=D, din=din, G=G, N=N, P=P, H=din // P,
                hq=cfg["n_heads"], hkv=cfg["n_kv_heads"], hd=cfg["head_dim"],
                J=len(cfg["hybrid_layer_ids"]), M=cfg["num_mem_blocks"],
                r=cfg["adapter_rank"], Fw=cfg["d_ff"])


def shapes(cfg: dict) -> dict:
    """{path: (shape, kind)} of every leaf of the published ``hybrid``
    block, in the program's tree order (kinds as ``weights`` makes
    them)."""
    if not cfg.get("hybrid_layer_ids"):
        raise ValueError(f"{cfg['name']}: the benchmark's hybrid reference "
                         f"is the published block (hybrid_layer_ids)")
    s = _sizes(cfg)
    L, V = cfg["n_layers"], cfg["vocab_size"]
    D, din, G, N, H = s["D"], s["din"], s["G"], s["N"], s["H"]
    hq, hkv, hd, J, M = s["hq"], s["hkv"], s["hd"], s["J"], s["M"]
    cd, k, Fw, r = din + 2 * G * N, cfg["ssm_conv"], s["Fw"], s["r"]
    out = {
        "embed.tok": ((V, D), ("normal", D)),
        "layers.ln1": ((L, D), ("norm",)),
        "layers.ssm.in_proj": ((L, D, din + cd + H), ("normal", D)),
        "layers.ssm.conv_w": ((L, k, cd), ("normal", k)),
        "layers.ssm.conv_b": ((L, cd), ("norm",)),
        "layers.ssm.A_log": ((L, H), ("A_log",)),
        "layers.ssm.D": ((L, H), ("ones",)),
        "layers.ssm.dt_bias": ((L, H), ("dt_bias",)),
        "layers.ssm.norm": ((L, din), ("norm",)),
        "layers.ssm.out_proj": ((L, din, D), ("normal", din)),
        "shared.ln1": ((M, 2 * D), ("norm",)),
        "shared.attn.wq": ((M, 2 * D, hq * hd), ("normal", 2 * D)),
        "shared.attn.wk": ((M, 2 * D, hkv * hd), ("normal", 2 * D)),
        "shared.attn.wv": ((M, 2 * D, hkv * hd), ("normal", 2 * D)),
        "shared.attn.wo": ((M, hq * hd, D), ("normal", hq * hd)),
        "shared.ln2": ((M, D), ("norm",)),
        "shared.mlp.w_up": ((M, D, Fw), ("normal", D)),
        "shared.mlp.w_down": ((M, Fw, D), ("normal", Fw)),
        "shared.mlp.w_gate": ((M, D, Fw), ("normal", D)),
        "hybrid.adapter_down": ((J, D, r), ("normal", D)),
        "hybrid.adapter_up": ((J, r, 2 * Fw), ("normal", r)),
        "hybrid.linear": ((J, D, D), ("normal", D)),
        "final_norm": ((D,), ("norm",)),
    }
    return out


def _rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) at positions 0..S-1, over all hd dims (NeoX
    halves, transformers' ``rotate_half``)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, x: torch.Tensor, cfg: dict, precision: str):
    """Causal attention of x (B, S, 2D) -> (B, S, D), scale (hd/2)^-1/2."""
    Bsz, S, _ = x.shape
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    theta = float(cfg.get("rope_theta", 10000.0))
    q = _rotary(matmul(x, p["wq"], precision).reshape(Bsz, S, hq, hd), theta)
    k = _rotary(matmul(x, p["wk"], precision).reshape(Bsz, S, hkv, hd), theta)
    v = matmul(x, p["wv"], precision).reshape(Bsz, S, hkv, hd)
    k = k.repeat_interleave(hq // hkv, dim=2)
    v = v.repeat_interleave(hq // hkv, dim=2)
    scale = (hd / 2) ** -0.5
    out = torch.empty_like(q)
    for r0 in range(0, S, QUERY_ROWS):
        r1 = min(S, r0 + QUERY_ROWS)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1], k[:, :r1]) * scale
        later = torch.arange(r1, device=x.device)[None, :] > \
            torch.arange(r0, r1, device=x.device)[:, None]
        s = s.masked_fill(later, float("-inf")).softmax(-1)
        out[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", s, v[:, :r1])
        del s
    return matmul(out.reshape(Bsz, S, hq * hd), p["wo"], precision)


def shared(params: dict, cfg: dict, j: int, h, emb, precision: str):
    """Invocation j of the shared blocks -> t (B, S, D)."""
    b = j % cfg["num_mem_blocks"]
    sh, hy = params["shared"], params["hybrid"]
    pick = lambda t: t[b].to(F32)
    eps = cfg["norm_eps"]
    x = rmsnorm(torch.cat([h, emb], dim=-1), pick(sh["ln1"]), eps)
    a = attention({k: pick(v) for k, v in sh["attn"].items()}, x, cfg,
                  precision)
    n = rmsnorm(a, pick(sh["ln2"]), eps)
    mlp = {k: pick(v) for k, v in sh["mlp"].items()}
    Fw = cfg["d_ff"]
    lo = matmul(matmul(n, hy["adapter_down"][j].to(F32), precision),
                hy["adapter_up"][j].to(F32), precision)
    gate = matmul(n, mlp["w_gate"], precision) + lo[..., :Fw]
    up = matmul(n, mlp["w_up"], precision) + lo[..., Fw:]
    m = matmul(F.gelu(gate) * up, mlp["w_down"], precision)
    return matmul(m, hy["linear"][j].to(F32), precision)


def mamba(p: dict, x: torch.Tensor, cfg: dict, precision: str):
    """One Mamba2 block with G B/C groups on its normed input x (B, S, D)."""
    Bsz, S, _ = x.shape
    s = _sizes(cfg)
    din, G, N, P, H = s["din"], s["G"], s["N"], s["P"], s["H"]
    k = cfg["ssm_conv"]
    zxbcdt = matmul(x, p["in_proj"], precision)
    z, xbc, dt = zxbcdt.split([din, din + 2 * G * N, H], dim=-1)
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(padded[:, i:i + S] * p["conv_w"][i] for i in range(k))
    xbc = F.silu(conv + p["conv_b"])
    xin, Bm, Cm = xbc.split([din, G * N, G * N], dim=-1)
    Bm, Cm = Bm.reshape(Bsz, S, G, N), Cm.reshape(Bsz, S, G, N)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(Bsz, S, H, P)
    per = H // G
    y = torch.cat([ssd(xh[:, :, g * per:(g + 1) * per],
                       dt[:, :, g * per:(g + 1) * per],
                       A[g * per:(g + 1) * per], Bm[:, :, g], Cm[:, :, g],
                       cfg["ssm_chunk"]) for g in range(G)], dim=2)
    y = y + p["D"][:, None] * xh
    g = (y.reshape(Bsz, S, din) * F.silu(z)).reshape(Bsz, S, G, din // G)
    g = (g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + cfg["norm_eps"])
         ).reshape(Bsz, S, din) * (1.0 + p["norm"])
    return matmul(g, p["out_proj"], precision)


def logits(params: dict, cfg: dict, tokens: torch.Tensor, *,
           rows: slice | None = None,
           precision: str = "fp32") -> torch.Tensor:
    """Float32 logits (B, S, V) of tokens (B, S), or of positions ``rows``
    only."""
    emb = params["embed"]["tok"].to(F32)[tokens.long()]
    h = emb
    calls = {i: j for j, i in enumerate(cfg["hybrid_layer_ids"])}
    lay = params["layers"]
    for i in range(cfg["n_layers"]):
        x = h
        if i in calls:
            x = h + shared(params, cfg, calls[i], h, emb, precision)
        p = {k: v[i].to(F32) for k, v in lay["ssm"].items()}
        h = h + mamba(p, rmsnorm(x, lay["ln1"][i].to(F32), cfg["norm_eps"]),
                      cfg, precision)
    return unembed(params, h if rows is None else h[:, rows], cfg, precision)
