"""nemotron-4-15b [dense] — GQA, squared-ReLU. [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    head_dim=128,
    activation="relu2",
    source="arXiv:2402.16819; unverified",
)
