"""minicpm3-4b [dense, MLA] — hf:openbmb/MiniCPM3-4B.

62L d_model=2560 40H (kv=40 in the GQA sense, but attention is MLA: all heads
share a 256-dim compressed KV latent) d_ff=6400 vocab=73448. MLA dims follow
the MiniCPM3 model card: q_lora=768, kv_lora=256, nope=64, rope=32, v=64.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    source="hf:openbmb/MiniCPM3-4B",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    rope_theta=10000.0,
    activation="swiglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    # MLA's per-head K/V expansion makes the sequence-sharded residual
    # stream pay off in training too
    train_seq_shard=True,
)
