"""internvl2-76b [vlm] — InternViT + InternLM2 backbone; the vision tower is
a stub (input_specs provides precomputed patch embeddings).
[arXiv:2404.16821; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    activation="silu",
    frontend="vision",
    frontend_tokens=256,
    serve_param_sharding="fsdp",   # 152GB bf16 params: TP-16 alone is too tight
    source="arXiv:2404.16821; unverified",
)
