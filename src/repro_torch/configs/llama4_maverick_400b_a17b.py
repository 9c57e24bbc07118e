"""llama4-maverick-400b-a17b [moe] — hf:meta-llama/Llama-4-Scout-17B-16E family.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1
with a Llama-4-style shared expert (early-fusion multimodal in the real model;
the assignment exercises the text trunk — image tokens would enter through the
same embedding stream).

Memory policy: at ~740B weights (128 experts x 48 layers) this arch trains
with bf16 params, bf16-momentum SGD and ZeRO-1 state sharding.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    attn_type="gqa",
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192,
                  capacity_factor=1.25, shared_expert=True),
    rope_theta=500000.0,
    activation="swiglu",
    optimizer="sgdm_bf16",
    param_dtype="bfloat16",
)
