"""whisper-medium [audio] — arXiv:2212.04356.

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865. Encoder-decoder: 24
encoder + 24 decoder layers, GELU MLP, LayerNorm, learned positions (encoder
positions are sinusoidal in the original; the dry-run treats both as learned
tables of the right shape). The mel-spectrogram + conv frontend is a STUB —
``input_specs()`` feeds precomputed frame embeddings (B, 1500, 1024).
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=24,                       # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    attn_type="gqa",
    rope_theta=0.0,                    # no rope; learned absolute positions
    norm_type="layernorm",
    activation="gelu",
    encdec=EncDecConfig(n_encoder_layers=24, n_frames=1500),
)
