"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    activation="gelu",
    ssm_state=64,
    ssm_head_dim=64,
    hybrid_attn_every=6,   # one shared attn+mlp block applied every 6 mamba layers
    source="arXiv:2411.15242; hf",
)
