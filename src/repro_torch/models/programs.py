"""ModelProgram: the uniform ABI every architecture exposes to the Hydra
runtime and the launchers.

Entry points (weights are arguments, never closed over, so every tenant
of one architecture shares one program):
  init(seed, device)                 -> params (fp32 unless dtype given)
  prefill(params, batch)             -> (last_logits, cache)
  decode_step(params, cache, batch)  -> (logits, cache)   [cache in place]
  cache_specs(batch, seq)            -> {name: TensorSpec} (no allocation)

A batch holds ``tokens`` (B,S) int32, and ``embeds`` where the family
takes them: a vlm's prefix (B,frontend_tokens,D), an audio model's frames
(B,S,D) in place of tokens. An moe model routes within
``n_route_groups`` groups: one per row in decode, one per 2048 tokens
otherwise. The training entry points (``loss_fn``, ``make_train_step``)
have no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.moe import n_route_groups


class TensorSpec(NamedTuple):
    """Shape/dtype stand-in for a buffer that is not allocated."""
    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * self.dtype.itemsize


class ModelProgram:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------
    def init(self, seed: int = 0, device=None, dtype=torch.float32):
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on ``device`` (CUDA unless the caller passes another)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tf.init_params(gen, self.cfg, dtype=dtype)

    def _n_groups(self, batch) -> int:
        if self.cfg.moe is None:
            return 1
        tokens = batch["tokens"] if "tokens" in batch else batch["embeds"]
        B, S = tokens.shape[0], tokens.shape[1]
        if self.cfg.family == "vlm":
            S = S + self.cfg.frontend_tokens
        kind = "decode" if S == 1 else "other"
        return n_route_groups(B * S, kind, B)

    # ------------------------------------------------------------------
    def prefill(self, params, batch):
        return tf.prefill(params, self.cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"),
                          n_groups=self._n_groups(batch))

    def decode_step(self, params, cache, batch):
        return tf.decode_step(params, self.cfg, cache,
                              tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"),
                              n_groups=self._n_groups(batch))

    # ------------------------------------------------------------------
    # Shape stand-ins (arena sizing) — never allocate.
    # ------------------------------------------------------------------
    def cache_specs(self, batch: int, seq: int) -> dict:
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        specs = {}
        if cfg.family in ("ssm", "hybrid"):
            specs["conv"] = TensorSpec((cfg.n_layers, batch, cfg.ssm_conv - 1,
                                        ssm_mod.conv_dim(cfg)), dt)
            specs["state"] = TensorSpec((cfg.n_layers, batch, cfg.ssm_heads,
                                         cfg.ssm_head_dim, cfg.ssm_state),
                                        torch.float32)
        if cfg.family != "ssm":
            n_kv = tf.hybrid_groups(cfg) if cfg.family == "hybrid" \
                else cfg.n_layers
            specs["k"] = specs["v"] = TensorSpec(
                (n_kv, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim), dt)
        specs["length"] = TensorSpec((batch,), torch.int32)
        return specs

    def cache_bytes(self, batch: int, seq: int) -> int:
        return sum(s.nbytes for s in self.cache_specs(batch, seq).values())
