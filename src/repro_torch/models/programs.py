"""ModelProgram: the uniform ABI every architecture exposes to the Hydra
runtime and the launchers.

Entry points (weights are arguments, never closed over, so every tenant
of one architecture shares one program):
  init(seed, device)                 -> params (fp32 unless dtype given)
  prefill(params, batch)             -> (last_logits, cache)
  decode_step(params, cache, batch)  -> (logits, cache)   [cache in place]
  cache_specs(batch, seq)            -> {name: TensorSpec} (no allocation)

Training (``loss_fn``/``make_train_step``) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import transformer as tf


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

    # ------------------------------------------------------------------
    def prefill(self, params, batch):
        return tf.prefill(params, self.cfg, batch["tokens"])

    def decode_step(self, params, cache, batch):
        return tf.decode_step(params, self.cfg, cache, batch["tokens"])

    # ------------------------------------------------------------------
    # Shape stand-ins (arena sizing) — never allocate.
    # ------------------------------------------------------------------
    def cache_specs(self, batch: int, seq: int) -> dict:
        cfg = self.cfg
        tf._require_dense(cfg)
        kv = TensorSpec((cfg.n_layers, batch, seq, cfg.n_kv_heads,
                         cfg.resolved_head_dim), torch_dtype(cfg.dtype))
        return {"k": kv, "v": kv,
                "length": TensorSpec((batch,), torch.int32)}

    def cache_bytes(self, batch: int, seq: int) -> int:
        return sum(s.nbytes for s in self.cache_specs(batch, seq).values())
