"""musicgen-large [audio] — decoder-only over EnCodec tokens; frontend is a
stub (input_specs provides precomputed frame embeddings).
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    activation="gelu",
    frontend="audio",
    source="arXiv:2306.05284; hf",
)
