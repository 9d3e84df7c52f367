"""gemma3-1b [dense] — 5:1 local:global sliding-window, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    activation="gelu",
    rope_theta=1000000.0,
    tie_embeddings=True,
    sliding_window=512,
    global_every=6,   # 5 local : 1 global
    source="hf:google/gemma-3-1b-pt; unverified",
)
