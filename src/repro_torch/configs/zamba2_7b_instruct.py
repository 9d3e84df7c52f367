"""zamba2-7b-instruct [hybrid] — the published Zamba2 block: 81 Mamba2
layers with two B/C groups; before each of the 13 ``hybrid_layer_ids``
one of two shared attention+MLP blocks (taking turns) reads [hidden ;
embeddings], with rank-128 MLP adapters and a linear per invocation.
[https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json]

The JAX package has no counterpart, so the config is found by
``get_config`` but not listed by ``list_archs`` (the archs held against
the JAX package)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b-instruct",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=224,
    activation="gelu_exact",
    rope_theta=10000.0,
    norm_eps=1e-5,
    tie_embeddings=True,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_groups=2,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2,
    adapter_rank=128,
    source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct",
)
