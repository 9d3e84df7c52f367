"""Plain-PyTorch oracles for the hand-written kernels.

Transcribed from ``repro.kernels.ref`` with its rounding points kept:
q is scaled in q's dtype, logits are accumulated in fp32, the softmax
probabilities are cast back to q's dtype before the PV product, and
masks use ``NEG_INF = -1e30`` (not ``-inf``), so a row with no valid key
averages V uniformly instead of giving NaN. The SSD scan keeps the
reference's points too: all math in fp32, padding with ``dt=0`` to a
multiple of the chunk, y cast back to x's dtype, the final state in fp32.

These are the CPU path of every kernel wrapper and the yardstick that
``chip_smoke.py`` holds each CUDA kernel to on the card. The backward
kernels' plain versions (``*_bwd_ref``) are autograd's gradients of
these, as the reference's training path differentiates its oracles.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    # jnp: q * jnp.asarray(scale, q.dtype) — the scale is rounded to q's
    # dtype first, and the product is rounded to q's dtype
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(dtype)


def rmsnorm_bwd_ref(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    eps: float = 1e-5) -> tuple:
    """(dx, dw): autograd's gradient of ``rmsnorm_ref`` for output grad dy."""
    with torch.enable_grad():
        x_, w_ = x.detach().requires_grad_(), w.detach().requires_grad_()
        return torch.autograd.grad(rmsnorm_ref(x_, w_, eps), (x_, w_), dy)


# ---------------------------------------------------------------------------
# Flash attention (prefill): GQA + causal + optional sliding window
# ---------------------------------------------------------------------------
def flash_attention_ref(q: torch.Tensor,      # (B, S, Hq, hd)
                        k: torch.Tensor,      # (B, S, Hkv, hd)
                        v: torch.Tensor,      # (B, S, Hkv, hd)
                        *, causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5

    qg = _scaled_q(q, scale).reshape(B, S, Hkv, group, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype).float(), v.float())
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, dout, *, causal: bool = True,
                            window: int | None = None,
                            scale: float | None = None) -> tuple:
    """(dq, dk, dv): autograd's gradient of ``flash_attention_ref`` for
    output grad dout."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_ref(*ins, causal=causal, window=window,
                                  scale=scale)
        return torch.autograd.grad(out, ins, dout)


# ---------------------------------------------------------------------------
# Decode attention: one query token against a (possibly partial) KV cache
# ---------------------------------------------------------------------------
def decode_attention_ref(q: torch.Tensor,        # (B, Hq, hd)
                         k_cache: torch.Tensor,  # (B, S, Hkv, hd)
                         v_cache: torch.Tensor,  # (B, S, Hkv, hd)
                         lengths: torch.Tensor,  # (B,) valid entries per row
                         *, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    B, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5

    qg = _scaled_q(q, scale).reshape(B, Hkv, group, hd)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
    kpos = torch.arange(S, device=q.device)[None, :]           # (1, S)
    lens = lengths.to(torch.int64)[:, None]
    valid = kpos < lens                                        # (B, S)
    if window is not None:
        valid &= kpos > (lens - 1 - window)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(q.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba2 SSD chunked scan (state-space duality)
# ---------------------------------------------------------------------------
def _cumsum(a: torch.Tensor) -> torch.Tensor:
    """fp32 cumsum over the last dim, accumulated in fp64 and rounded once
    per element. That is what torch's CPU cumsum does for fp32; the CUDA
    cumsum sums in fp32 in a scan order of its own, and at a chunk of 256
    (|a_cs| ~ 200) that order alone moves y past the fp32 2e-5 check. The
    CUDA kernel accumulates the same way, so both round alike."""
    return torch.cumsum(a.double(), dim=-1).to(a.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} a[..., k] for
    j <= i, -inf above the diagonal (so exp() of it is 0, never inf*0)."""
    L = a.shape[-1]
    cum = _cumsum(a)
    seg = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.where(mask, seg, float("-inf"))


def ssd_scan_ref(x: torch.Tensor,        # (B, S, H, P) inputs per head
                 dt: torch.Tensor,       # (B, S, H) softplus'd step sizes
                 A: torch.Tensor,        # (H,) negative decay rates
                 Bm: torch.Tensor,       # (B, S, N) or (B, S, G, N) input
                 Cm: torch.Tensor,       # matrix; output matrix alike
                 *, chunk: int = 64,
                 init_state: torch.Tensor | None = None,   # (B, H, P, N)
                 return_state: bool = False):
    """Chunked SSD (Mamba2, arXiv:2405.21060 listing 1), all math in fp32:

    y[t] = C[t] . state[t],  state[t] = exp(dt[t]*A) * state[t-1]
                                        + dt[t] * B[t] (outer) x[t]

    y comes back in x's dtype, the final state (B, H, P, N) in fp32. With
    G groups head h reads B and C of group h // (H / G).
    """
    Bsz, S, H, P = x.shape
    if Bm.dim() == 3:                                   # one group
        Bm, Cm = Bm[:, :, None], Cm[:, :, None]
    G, N = Bm.shape[2], Bm.shape[3]
    J = H // G                                          # heads a group
    if S % chunk:
        # pad with dt=0 tokens: decay exp(0)=1 and contribution dt*Bx=0, so
        # the final state is unchanged and the padded outputs are dropped
        pad = chunk - S % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))
        out = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                           init_state=init_state, return_state=return_state)
        if return_state:
            return out[0][:, :S], out[1]
        return out[:, :S]
    nc = S // chunk

    f32 = torch.float32
    x_ = x.to(f32).reshape(Bsz, nc, chunk, H, P)
    dt_ = dt.to(f32).reshape(Bsz, nc, chunk, H)
    B_ = Bm.to(f32).reshape(Bsz, nc, chunk, G, N)
    C_ = Cm.to(f32).reshape(Bsz, nc, chunk, G, N)
    by_group = lambda t: t.unflatten(2, (G, J))         # (b,c,h,..) heads

    a = (dt_ * A.to(f32)).movedim(-1, -2)               # (b,c,h,l) log-decay
    a_cs = _cumsum(a)                                   # (b,c,h,l)
    dtx = dt_[..., None] * x_                           # (b,c,l,h,p)

    # The products are two-operand einsums, grouped as the Pallas kernel
    # groups them. (Three-operand einsums here were seen to round
    # differently from one CPU process to the next.) B and C are taken
    # per group and broadcast over the group's heads, never gathered, so
    # one group runs the products of a (B, S, N) scan.
    # 1. intra-chunk (diagonal block) output: ((C B^T) o L) (dt x)
    L = torch.exp(_segsum(a))                           # (b,c,h,l,s)
    CB = torch.einsum("bclgn,bcsgn->bcgls", C_, B_)
    CBL = (CB[:, :, :, None] * by_group(L)).flatten(2, 3)
    Y_diag = torch.einsum("bchls,bcshp->bclhp", CBL, dtx)

    # 2. per-chunk final states: (dt x)^T (B exp(a_cs[-1] - a_cs))
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)     # (b,c,h,l)
    Bd = (B_.movedim(3, 2)[:, :, :, None]
          * by_group(decay_states)[..., None]).flatten(2, 3)  # (b,c,h,l,n)
    states = torch.einsum("bchln,bclhp->bchpn", Bd, dtx)

    # 3. inter-chunk recurrence, in chunk order
    chunk_decay = torch.exp(a_cs[..., -1])              # (b,c,h)
    cur = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
           if init_state is None else init_state.to(f32))
    prevs = []
    for c in range(nc):
        prevs.append(cur)
        cur = cur * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prevs, dim=1)             # (b,c,h,p,n)

    # 4. state -> output contribution: (C state^T) exp(a_cs)
    state_decay = torch.exp(a_cs).movedim(-1, -2)       # (b,c,l,h)
    Y_off = torch.einsum("bclgn,bcgjpn->bclgjp", C_,
                         by_group(prev_states)).flatten(3, 4) \
        * state_decay[..., None]

    y = (Y_diag + Y_off).reshape(Bsz, S, H, P).to(x.dtype)
    if return_state:
        return y, cur
    return y


def ssd_scan_bwd_ref(dy, x, dt, A, Bm, Cm, *, chunk: int = 64,
                     init_state=None, dfinal=None) -> tuple:
    """(dx, ddt, dA, dB, dC, d init_state or None): autograd's gradient of
    ``ssd_scan_ref`` for y's cotangent dy and, optionally, the final
    state's ``dfinal``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        s0 = None if init_state is None else \
            init_state.detach().requires_grad_()
        y, sf = ssd_scan_ref(*ins, chunk=chunk, init_state=s0,
                             return_state=True)
        outs, cots = [y], [dy]
        if dfinal is not None:
            outs.append(sf)
            cots.append(dfinal.to(sf.dtype))
        g = torch.autograd.grad(outs, ins + ([s0] if s0 is not None else []),
                                cots)
    return tuple(g) + ((None,) if s0 is None else ())


def ssd_decode_ref(x: torch.Tensor,      # (B, H, P) single-token input
                   dt: torch.Tensor,     # (B, H)
                   A: torch.Tensor,      # (H,)
                   Bm: torch.Tensor,     # (B, N) or (B, G, N)
                   Cm: torch.Tensor,     # (B, N) or (B, G, N)
                   state: torch.Tensor):  # (B, H, P, N) fp32
    """Single-token SSD state update and output: (y in x's dtype, the new
    fp32 state). The reference runs this plain version on every backend
    (it is no Pallas kernel), and so does the port. With G groups head h
    reads B and C of group h // (H / G): each (row, group) is a row of the
    one-group update, so one group runs that update's ops unchanged. No
    host sync, so a CUDA graph captures it."""
    f32 = torch.float32
    Bsz, H, P = x.shape
    G = Bm.shape[1] if Bm.dim() == 3 else 1
    # (B, H, ...) -> (B*G, H/G, ...): a row per (row, group)
    rows = lambda t: t.reshape(Bsz * G, H // G, *t.shape[2:])
    xf, dtf = rows(x.to(f32)), rows(dt.to(f32))
    Bf, Cf = (t.to(f32).reshape(Bsz * G, -1) for t in (Bm, Cm))
    decay = torch.exp(dtf * rows(A.to(f32)[None, :].expand(Bsz, H)))
    dBx = torch.einsum("bh,bhp,bn->bhpn", dtf, xf, Bf)
    new_state = rows(state) * decay[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", new_state, Cf)
    return y.reshape(Bsz, H, P).to(x.dtype), new_state.reshape(state.shape)


# ---------------------------------------------------------------------------
# The Mamba2 mixer's elementwise chain around the scan
# ---------------------------------------------------------------------------
def causal_conv_ref(xbc: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, xbc (B,S,C), w (k,C), b (C,): k shifted
    multiply-adds in xbc's dtype, then SiLU, as the reference writes it.
    (``F.conv1d`` would run fp32 through cuDNN in TF32 on the card and
    round elsewhere than the reference.)"""
    k, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i].to(xbc.dtype) for i in range(k))
    return F.silu(out + b.to(xbc.dtype))


def mamba_conv_ref(xbc: torch.Tensor, dt: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, dt_bias: torch.Tensor,
                   A_log: torch.Tensor) -> tuple:
    """The prefill's conv and the scan's dt and A: (SiLU(conv(xbc) + b)
    in xbc's dtype, softplus'd dt fp32, A fp32)."""
    return (causal_conv_ref(xbc, w, b),
            F.softplus(dt.float() + dt_bias.float()),
            -torch.exp(A_log.float()))


def gated_norm_ref(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float, groups: int = 1) -> torch.Tensor:
    g = y.float() * F.silu(z.float())
    if groups > 1:     # each group's channels normalised on their own
        g = g.unflatten(-1, (groups, -1))
        var = torch.mean(g * g, dim=-1, keepdim=True)
        g = (g * torch.rsqrt(var + eps)).flatten(-2)
        return (g * (1.0 + w.float())).to(y.dtype)
    # one group: the whole of d_inner, the form the training launcher
    # also runs on a DTensor split over d_inner
    var = torch.mean(g * g, dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * (1.0 + w.float())).to(y.dtype)


def mamba_gate_ref(y: torch.Tensor, x: torch.Tensor, D: torch.Tensor,
                   z: torch.Tensor, w: torch.Tensor, eps: float,
                   groups: int = 1) -> torch.Tensor:
    """The D skip and the gated norm: y, x (..., H, P) in the model dtype,
    D (H,), z (..., H*P) -> (..., H*P) in y's dtype."""
    y = y + D.to(x.dtype)[:, None] * x
    return gated_norm_ref(y.flatten(-2), z, w, eps, groups)
