"""phi-3-vision-4.2b [vlm] — hf:microsoft/Phi-3-vision-128k-instruct.

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064. phi3-mini trunk + CLIP
vision tower. The ViT/projector is a STUB — ``input_specs()`` supplies
precomputed patch embeddings (B, 576, 3072) merged at image-token positions.
"""
from repro_torch.configs.base import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    attn_type="gqa",
    rope_theta=10000.0,
    activation="swiglu",
    vlm=VLMConfig(n_image_tokens=576),
)
