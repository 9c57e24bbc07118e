"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000. Repeating pattern of
two RG-LRU residual blocks followed by one local-attention block (window
2048); 38 = 12 x (R,R,A) + 2 trailing recurrent layers. GeGLU MLP, RMSNorm,
head_dim=256 MQA on the attention layers. long_500k decode runs natively:
state = RG-LRU hidden + a 2048-token local window cache.
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attn_type="gqa",
    rope_theta=10000.0,
    activation="geglu",
    rglru=RGLRUConfig(lru_width=4096, conv_width=4, window=2048,
                      pattern=("rglru", "rglru", "attn")),
    long_context_window=None,          # native sub-quadratic
)
