"""Optimizer and learning-rate schedules of the trainer."""
from repro_torch.optim.adamw import AdamW, global_norm
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamW", "global_norm", "warmup_cosine", "constant"]
