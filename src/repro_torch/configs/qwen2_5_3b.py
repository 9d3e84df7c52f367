"""qwen2.5-3b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    head_dim=128,
    activation="silu",
    qkv_bias=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
