"""Architecture configuration dataclasses.

Every assigned architecture is expressed as an ``ArchConfig``. The full
configs are exercised only via the dry-run (ShapeDtypeStruct, no
allocation); smoke tests use ``reduced()`` variants of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    activation: str = "silu"                # silu | relu2 | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- sliding-window / local:global pattern (gemma3) ---
    sliding_window: Optional[int] = None    # window size for local layers
    global_every: Optional[int] = None      # every k-th layer is global
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: Optional[int] = None         # per-head state size N
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256                    # SSD chunk length
    # --- hybrid (zamba2-style shared attention) ---
    hybrid_attn_every: Optional[int] = None  # shared attn block every k layers
    # --- modality frontend stub ---
    frontend: Optional[str] = None          # vision | audio
    frontend_tokens: int = 0                # prefix embedding positions (vlm)
    # --- numerics / serving ---
    dtype: str = "bfloat16"
    serve_param_sharding: str = "tp"        # tp | fsdp (big models need fsdp)
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if the arch can serve ``long_500k`` (sub-quadratic attention
        state: SSM, hybrid, or sliding-window local attention)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        per_layer = 0
        attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
        if self.moe is not None:
            ffn = self.moe.num_experts * (3 * d * self.d_ff) + d * self.moe.num_experts
        else:
            ffn = 3 * d * self.d_ff if self.activation == "silu" else 2 * d * self.d_ff
        if self.family == "ssm":
            # mamba2 block: in_proj (2*d_inner + 2*groups*N + heads), out_proj
            din, N, H = self.d_inner, self.ssm_state or 128, self.ssm_heads
            per_layer = d * (2 * din + 2 * N + H) + din * d + 2 * d
        elif self.family == "hybrid":
            din, N, H = self.d_inner, self.ssm_state or 64, self.ssm_heads
            mamba = d * (2 * din + 2 * N + H) + din * d + 2 * d
            per_layer = mamba
            shared = attn + 3 * d * self.d_ff  # one shared attn+mlp block total
            return emb + head + self.n_layers * per_layer + shared
        else:
            per_layer = attn + ffn + 2 * d
        return emb + head + self.n_layers * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        dense_ffn_total = self.n_layers * self.moe.num_experts * (3 * d * self.d_ff)
        active_ffn_total = self.n_layers * self.moe.top_k * (3 * d * self.d_ff)
        return self.param_count() - dense_ffn_total + active_ffn_total

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4 if self.family == "hybrid" else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            frontend_tokens=4 if self.frontend == "vision" else 0,
            ssm_head_dim=16,
            ssm_chunk=8,
        )
        if self.moe is not None:
            # high capacity factor: no token drops, so reduced-config tests
            # are exactly composition-invariant (full configs keep 1.25)
            kw["moe"] = MoEConfig(num_experts=4, top_k=2,
                                  capacity_factor=4.0)
        if self.ssm_state is not None:
            kw["ssm_state"] = 16
        if self.sliding_window is not None:
            kw["sliding_window"] = 8
        if self.hybrid_attn_every is not None:
            kw["hybrid_attn_every"] = 2
        return dataclasses.replace(self, **kw)
