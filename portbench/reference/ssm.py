"""Plain float32 reference of the ``ssm`` family: Mamba2 blocks (SSD,
arXiv:2405.21060) with one B/C group, as the port's configuration
defines them, from token ids to logits. No kernel, cache or batching.
``shapes`` gives the leaves it reads, which ``weights`` makes.

Per block, for x (B, S, D) after the pre-norm:
  [z, xBC, dt] = x W_in
  xBC = silu(causal depthwise conv over ``ssm_conv`` taps + bias)
  [x, B, C] = xBC;  dt = softplus(dt + dt_bias);  A = -exp(A_log)
  h_t = exp(dt_t A) h_{t-1} + dt_t x_t (outer) B_t;  y_t = h_t C_t + D x_t
  out = (rmsnorm(y * silu(z)) * (1 + w_norm)) W_out
and the residual h + out. The scan is computed exactly, in blocks of
``ssm_chunk`` positions (quadratic inside a block, the state carried
between blocks), with the decay sums in float64.

Imports torch and the references beside it only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.layers import F32, matmul, rmsnorm

F64 = torch.float64


def shapes(cfg: dict) -> dict:
    """{path: (shape, kind)} of every leaf of the ``ssm`` family, in the
    program's tree order (kinds as ``weights`` makes them)."""
    L, D, V = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    din = cfg["ssm_expand"] * D
    N, P = cfg["ssm_state"], cfg["ssm_head_dim"]
    H = din // P
    cd = din + 2 * N
    k = cfg["ssm_conv"]
    out = {
        "embed.tok": ((V, D), ("normal", D)),
        "layers.ln1": ((L, D), ("norm",)),
        "layers.ssm.in_proj": ((L, D, 2 * din + 2 * N + H), ("normal", D)),
        "layers.ssm.conv_w": ((L, k, cd), ("normal", k)),
        "layers.ssm.conv_b": ((L, cd), ("norm",)),
        "layers.ssm.A_log": ((L, H), ("A_log",)),
        "layers.ssm.D": ((L, H), ("ones",)),
        "layers.ssm.dt_bias": ((L, H), ("dt_bias",)),
        "layers.ssm.norm": ((L, din), ("norm",)),
        "layers.ssm.out_proj": ((L, din, D), ("normal", din)),
    }
    out["final_norm"] = ((D,), ("norm",))
    if not cfg["tie_embeddings"]:
        out["lm_head"] = ((D, V), ("normal", D))
    return out


def ssd(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    """y_t = sum_{s <= t} (C_t . B_s) exp(sum_{s < r <= t} dt_r A) dt_s x_s;
    x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N)."""
    Bsz, S, H, P = x.shape
    pad = (-S) % chunk
    if pad:   # dt = 0 past the end: no input and no decay
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    c = (S + pad) // chunk
    N = Bm.shape[-1]
    x = x.reshape(Bsz, c, chunk, H, P)
    dt = dt.reshape(Bsz, c, chunk, H)
    Bm, Cm = Bm.reshape(Bsz, c, chunk, N), Cm.reshape(Bsz, c, chunk, N)
    cs = torch.cumsum((dt * A).to(F64), dim=2)              # (b,c,l,h)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]        # (b,c,l,s,h)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri[None, None, :, :, None], seg, -torch.inf)
    decay = torch.exp(decay).to(F32)
    dtx = dt[..., None] * x                                  # (b,c,l,h,p)
    cb = torch.einsum("bcln,bcsn->bcls", Cm, Bm)
    y = torch.einsum("bclsh,bcshp->bclhp", cb[..., None] * decay, dtx)
    # the state each block leaves, and the one entering each block
    to_end = torch.exp(cs[:, :, -1:, :] - cs).to(F32)        # (b,c,l,h)
    states = torch.einsum("bclh,bcln,bclhp->bchpn", to_end, Bm, dtx)
    block_decay = torch.exp(cs[:, :, -1, :]).to(F32)         # (b,c,h)
    h = torch.zeros(Bsz, H, P, N, dtype=F32, device=x.device)
    entering = []
    for i in range(c):
        entering.append(h)
        h = h * block_decay[:, i, :, None, None] + states[:, i]
    entering = torch.stack(entering, dim=1)                  # (b,c,h,p,n)
    from_start = torch.exp(cs).to(F32)                       # (b,c,l,h)
    y = y + torch.einsum("bcln,bchpn->bclhp", Cm, entering) \
        * from_start[..., None]
    return y.reshape(Bsz, c * chunk, H, P)[:, :S]


def mamba(p: dict, x: torch.Tensor, cfg: dict, precision: str):
    """One Mamba2 block's output for its normed input x (B, S, D)."""
    Bsz, S, _ = x.shape
    din = cfg["ssm_expand"] * cfg["d_model"]
    N, P, k = cfg["ssm_state"], cfg["ssm_head_dim"], cfg["ssm_conv"]
    H = din // P
    zxbcdt = matmul(x, p["in_proj"], precision)
    z, xbc, dt = zxbcdt.split([din, din + 2 * N, H], dim=-1)
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(padded[:, i:i + S] * p["conv_w"][i] for i in range(k))
    xbc = F.silu(conv + p["conv_b"])
    xin, Bm, Cm = xbc.split([din, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(Bsz, S, H, P)
    y = ssd(xh, dt, A, Bm, Cm, cfg["ssm_chunk"]) + p["D"][:, None] * xh
    g = y.reshape(Bsz, S, din) * F.silu(z)
    return matmul(rmsnorm(g, p["norm"], cfg["norm_eps"]), p["out_proj"],
                  precision)


def layer(params: dict, i: int) -> dict:
    """Layer ``i``'s leaves of the stacked per-layer tree, as float32."""
    return {k: v[i].to(F32) for k, v in params["layers"]["ssm"].items()}


def mamba_layer(params, i, h, cfg, precision):
    ln = params["layers"]["ln1"][i].to(F32)
    return h + mamba(layer(params, i), rmsnorm(h, ln, cfg["norm_eps"]), cfg,
                     precision)


def unembed(params, h, cfg, precision):
    h = rmsnorm(h, params["final_norm"].to(F32), cfg["norm_eps"])
    head = (params["embed"]["tok"].to(F32).T if cfg["tie_embeddings"]
            else params["lm_head"].to(F32))
    return matmul(h, head, precision)


def logits(params: dict, cfg: dict, tokens: torch.Tensor, *,
           rows: slice | None = None,
           precision: str = "fp32") -> torch.Tensor:
    """Float32 logits (B, S, V) of tokens (B, S), or of positions ``rows``
    only."""
    h = params["embed"]["tok"].to(F32)[tokens.long()]
    for i in range(cfg["n_layers"]):
        h = mamba_layer(params, i, h, cfg, precision)
    return unembed(params, h if rows is None else h[:, rows], cfg, precision)
