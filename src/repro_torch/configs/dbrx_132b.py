"""dbrx-132b [moe] — 16 experts, top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,                    # per-expert FFN width
    vocab_size=100352,
    head_dim=128,
    activation="silu",
    moe=MoEConfig(num_experts=16, top_k=4),
    serve_param_sharding="fsdp",   # 264GB bf16 params: must shard over data too
    source="hf:databricks/dbrx-base; unverified",
)
