"""llama3-8b [dense] — arXiv:2407.21783.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, rope theta 500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    source="arXiv:2407.21783",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    attn_type="gqa",
    rope_theta=500000.0,
    activation="swiglu",
)
