"""Plain-PyTorch oracles for the hand-written kernels.

Transcribed from ``repro.kernels.ref`` with its rounding points kept:
q is scaled in q's dtype, logits are accumulated in fp32, the softmax
probabilities are cast back to q's dtype before the PV product, and
masks use ``NEG_INF = -1e30`` (not ``-inf``), so a row with no valid key
averages V uniformly instead of giving NaN. The SSD scan keeps the
reference's points too: all math in fp32, padding with ``dt=0`` to a
multiple of the chunk, y cast back to x's dtype, the final state in fp32.

These are the CPU path of every kernel wrapper and the yardstick that
``chip_smoke.py`` holds each CUDA kernel to on the card.
"""
from __future__ import annotations

import torch

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
                 Bm: torch.Tensor,       # (B, S, N) input matrix, one group
                 Cm: torch.Tensor,       # (B, S, N) output matrix
                 *, chunk: int = 64,
                 init_state: torch.Tensor | None = None,   # (B, H, P, N)
                 return_state: bool = False):
    """Chunked SSD (Mamba2, arXiv:2405.21060 listing 1), all math in fp32:

    y[t] = C[t] . state[t],  state[t] = exp(dt[t]*A) * state[t-1]
                                        + dt[t] * B[t] (outer) x[t]

    y comes back in x's dtype, the final state (B, H, P, N) in fp32.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        # pad with dt=0 tokens: decay exp(0)=1 and contribution dt*Bx=0, so
        # the final state is unchanged and the padded outputs are dropped
        pad = chunk - S % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
        out = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                           init_state=init_state, return_state=return_state)
        if return_state:
            return out[0][:, :S], out[1]
        return out[:, :S]
    nc = S // chunk

    f32 = torch.float32
    x_ = x.to(f32).reshape(Bsz, nc, chunk, H, P)
    dt_ = dt.to(f32).reshape(Bsz, nc, chunk, H)
    B_ = Bm.to(f32).reshape(Bsz, nc, chunk, N)
    C_ = Cm.to(f32).reshape(Bsz, nc, chunk, N)

    a = (dt_ * A.to(f32)).movedim(-1, -2)               # (b,c,h,l) log-decay
    a_cs = _cumsum(a)                                   # (b,c,h,l)
    dtx = dt_[..., None] * x_                           # (b,c,l,h,p)

    # The products are two-operand einsums, grouped as the Pallas kernel
    # groups them. (Three-operand einsums here were seen to round
    # differently from one CPU process to the next.)
    # 1. intra-chunk (diagonal block) output: ((C B^T) o L) (dt x)
    L = torch.exp(_segsum(a))                           # (b,c,h,l,s)
    CB = torch.einsum("bcln,bcsn->bcls", C_, B_)
    Y_diag = torch.einsum("bchls,bcshp->bclhp", CB[:, :, None] * L, dtx)

    # 2. per-chunk final states: (dt x)^T (B exp(a_cs[-1] - a_cs))
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)     # (b,c,h,l)
    Bd = B_[:, :, None] * decay_states[..., None]       # (b,c,h,l,n)
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
    Y_off = torch.einsum("bcln,bchpn->bclhp", C_, prev_states) \
        * state_decay[..., None]

    y = (Y_diag + Y_off).reshape(Bsz, S, H, P).to(x.dtype)
    if return_state:
        return y, cur
    return y


def ssd_decode_ref(x: torch.Tensor,      # (B, H, P) single-token input
                   dt: torch.Tensor,     # (B, H)
                   A: torch.Tensor,      # (H,)
                   Bm: torch.Tensor,     # (B, N)
                   Cm: torch.Tensor,     # (B, N)
                   state: torch.Tensor):  # (B, H, P, N) fp32
    """Single-token SSD state update and output: (y in x's dtype, the new
    fp32 state). The reference runs this plain version on every backend
    (it is no Pallas kernel), and so does the port."""
    f32 = torch.float32
    xf, dtf = x.to(f32), dt.to(f32)
    decay = torch.exp(dtf * A.to(f32)[None, :])         # (B, H)
    dBx = torch.einsum("bh,bhp,bn->bhpn", dtf, xf, Bm.to(f32))
    new_state = state * decay[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.to(f32))
    return y.to(x.dtype), new_state
