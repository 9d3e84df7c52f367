"""Learning-rate schedules (step -> lr), a port of ``repro/optim/schedule.py``.

A schedule takes the step as a tensor or an int and returns a 0-d fp32
tensor on the step's device, so the optimizer reads the step counter it
keeps on the card without a host round trip.
"""
from __future__ import annotations

import math

import torch


def _as_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = _as_f32(step)
        warm = peak_lr * step / max(1, warmup_steps)
        t = torch.clamp((step - warmup_steps) /
                        max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return fn
