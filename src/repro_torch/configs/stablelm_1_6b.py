"""stablelm-1.6b [dense] — hf:stabilityai/stablelm-2-1_6b.

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352. StableLM-2 details:
LayerNorm (not RMSNorm), partial rotary embedding on 25% of head dims.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    attn_type="gqa",
    rope_theta=10000.0,
    rope_pct=0.25,
    norm_type="layernorm",
    activation="swiglu",
)
