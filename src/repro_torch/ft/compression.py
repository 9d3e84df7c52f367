"""Gradient compression with error feedback (int8 quantized all-reduce), a
port of ``repro/ft/compression.py``.

Wraps any optimizer: gradients are quantized to int8 with one scale per
tensor before the (conceptual) cross-pod reduction, the dequantized
values are applied, and the quantization error is fed back into the next
step's gradients, bounding the bias (Karimireddy et al., error-feedback
SGD).

In place, as the port's AdamW is: the fp32 residual becomes the
corrected gradient and then the new residual where it lies, and the
dequantized gradient is written over the grads it replaces (in fp32
chunks, see ``optim.adamw.chunks``), so no second set of gradients is
held. ``update`` therefore consumes ``grads``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.optim.adamw import chunks, tree_leaves, tree_map


def quantize(x: torch.Tensor) -> tuple:
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@dataclass(frozen=True)
class ErrorFeedbackCompression:
    """Optimizer wrapper: compress(grad + residual), apply, carry residual."""
    inner: object

    def init(self, params):
        return {
            "inner": self.inner.init(params),
            "residual": tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params),
        }

    @torch.no_grad()
    def update(self, grads, state, params):
        for g, r in zip(tree_leaves(grads), tree_leaves(state["residual"])):
            if g.dtype != torch.float32:
                raise TypeError("ErrorFeedbackCompression updates fp32 "
                                f"gradients in place, got {g.dtype}")
            r.add_(g)                       # r = corrected = g + residual
            lo, hi = torch.aminmax(r)
            scale = (torch.maximum(-lo, hi) + 1e-12) / 127.0
            for gc, rc in chunks(g, r):
                # dequantize(quantize(corrected)): the int8 round trip of
                # an integer in [-127, 127] is exact, so it is skipped
                torch.div(rc, scale, out=gc).round_().clamp_(-127, 127)
                gc.mul_(scale)
                rc.sub_(gc)                 # residual = corrected - deq
        new_params, inner_state, metrics = self.inner.update(
            grads, state["inner"], params)
        metrics = dict(metrics)
        metrics["compression_bits"] = torch.tensor(8.0, dtype=torch.float32)
        return new_params, {"inner": inner_state,
                            "residual": state["residual"]}, metrics
