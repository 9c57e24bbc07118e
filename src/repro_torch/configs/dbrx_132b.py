"""dbrx-132b [moe] — hf:databricks/dbrx-base.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16 experts top-4
(fine-grained). LayerNorm, rope theta 500k.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    attn_type="gqa",
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752,
                  capacity_factor=1.25, shared_expert=False),
    rope_theta=500000.0,
    norm_type="layernorm",
    activation="swiglu",
)
