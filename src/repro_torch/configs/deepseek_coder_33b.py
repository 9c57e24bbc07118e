"""deepseek-coder-33b [dense] — arXiv:2401.14196 (llama-arch).

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    source="arXiv:2401.14196",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    attn_type="gqa",
    rope_theta=100000.0,
    activation="swiglu",
)
