"""Assigned input-shape sets.

LM transformer shapes are seq_len x global_batch. ``decode_*`` / ``long_*``
lower ``serve_step`` (one new token against a KV cache of seq_len), NOT
``train_step``. ``long_500k`` requires sub-quadratic attention and only runs
for SSM / hybrid / sliding-window archs (see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg) -> list:
    """Shapes that are well-defined for this architecture."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.supports_long_context:
        out.append(SHAPES["long_500k"])
    return out
